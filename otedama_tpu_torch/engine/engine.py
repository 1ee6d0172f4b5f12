"""The mining engine: async orchestration of supervised device search
(counterpart of ``otedama_tpu/engine/engine.py``).

One async searcher per device backend keeps the card fed, rolls
extranonce2 spaces and pumps found shares to the submit callback:

  current job -> (extranonce2, ntime) -> JobConstants (host midstate) ->
  backend.search_group(launches) on the engine's device executor ->
  winners -> Share -> on_share

Every device call runs under a watchdog deadline from its device's
``DeviceSupervisor`` (``runtime/supervision.py``). A blown deadline
quarantines the device and re-shards its extranonce2 block over the
devices still mining; reintegration probes, each checked against the
host oracle, bring it back. ``switch_algorithm`` swaps the backend set
at one batch boundary, and retired backends are closed once their
in-flight calls have drained. Backends that search several extranonce2
spaces a call (``en2_fanout > 1``: multi-device backends) come with
ROADMAP A11 and are refused here. A device's hashrate is timed by when
each call's answer was in hand, not when the loop drained it (see
``_consume``). At a job change the new job's first call is dispatched
before the old job's calls still in flight are drained (the reference
drains first), so the card does not wait on the event loop between
jobs.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import itertools
import logging
import time
from typing import Awaitable, Callable, Protocol

from otedama_tpu_torch.engine import algos
from otedama_tpu_torch.engine.jobs import job_constants
from otedama_tpu_torch.engine.types import (
    DeviceStats,
    EngineState,
    EngineStats,
    Job,
    Share,
)
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.runtime import supervision
from otedama_tpu_torch.runtime.partition import ExtranonceCounter, NonceRange
from otedama_tpu_torch.runtime.search import JobConstants, SearchResult
from otedama_tpu_torch.runtime.supervision import (
    DeviceHungError,
    DeviceState,
    DeviceSupervisor,
)
from otedama_tpu_torch.utils import faults

log = logging.getLogger("otedama.engine")

ShareCallback = Callable[[Share], Awaitable[None]]


def _job_constants_batch(job: Job, en2s: list[bytes]) -> list[JobConstants]:
    """All of one dispatch unit's midstates in a single executor call."""
    return [job_constants(job, en2) for en2 in en2s]


def _canon_algo(name: str) -> str:
    """Canonical algorithm identity: aliases resolve through the registry
    and the sha256 family collapses to one name (``make_backend`` routes
    both to the same kernel)."""
    try:
        name = algos.get(name).name
    except KeyError:
        pass  # unknown names compare as themselves (and mismatch loudly)
    return "sha256d" if name == "sha256" else name


def _check_fanout(backends: dict) -> None:
    for name, backend in backends.items():
        if getattr(backend, "en2_fanout", 1) != 1:
            raise ValueError(
                f"backend {name} searches several extranonce2 spaces a "
                "call (en2_fanout > 1); multi-device backends come with "
                "ROADMAP A11"
            )


class SearchBackendProtocol(Protocol):
    name: str

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult: ...


@dataclasses.dataclass
class EngineConfig:
    worker_name: str = "otedama-tpu"
    algorithm: str = "sha256d"
    batch_size: int = 1 << 22
    # adopt a backend's preferred_batch when it exceeds batch_size: the
    # CUDA kernel takes 2^31 nonces in one launch
    auto_batch: bool = True
    # launches per group for grouped backends (all issued before one
    # read-back; two groups in flight), or searches in flight otherwise
    pipeline_depth: int = 3
    extranonce2_size: int = 4
    # stop searching a job after this age even without a replacement
    job_max_age: float = 120.0

    # -- device supervision (watchdog / quarantine / probes / drains) --------
    # stop()/switch_algorithm wait at most this long for in-flight device
    # calls before ABANDONING them (counted in snapshot): a wedged
    # executor thread must never hang process exit or an algorithm swap
    drain_timeout: float = 30.0
    # watchdog deadline = per-(backend, call key) call-duration EWMA x
    # this multiplier, floored by watchdog_floor; <= 0 disables the
    # watchdog entirely
    watchdog_multiplier: float = 8.0
    watchdog_floor: float = 5.0
    # deadline until the EWMA has watchdog_min_samples for a key: the
    # first call of a key may build the kernel (nvcc) if nothing warmed it
    watchdog_first_deadline: float = 1800.0
    watchdog_min_samples: int = 3
    # reintegration probes: precompile + one host-oracle-verified batch,
    # retried under exponential backoff; max_probes consecutive failures
    # mark the device DEAD (0 = probe forever)
    probe_timeout: float = 300.0
    probe_backoff: float = 1.0
    probe_backoff_max: float = 60.0
    max_probes: int = 8
    probe_count: int = 256
    # a searcher whose loop dies to a backend exception restarts under
    # capped exponential backoff instead of silently vanishing
    searcher_restart_backoff: float = 0.5
    searcher_restart_backoff_max: float = 30.0
    # a device whose abandoned calls still wedge this many executor
    # threads is refused further probes and marked DEAD: a flapping
    # device (hang -> reintegrate -> hang) must not bleed the device
    # executor dry one thread per incident (0 = no cap)
    max_wedged_calls: int = 8


class MiningEngine:
    """Owns device backends and turns jobs into shares."""

    def __init__(
        self,
        backends: dict[str, SearchBackendProtocol],
        on_share: ShareCallback | None = None,
        config: EngineConfig | None = None,
    ):
        if not backends:
            raise ValueError("need at least one search backend")
        _check_fanout(backends)
        self.backends = backends
        self.on_share = on_share
        self.config = config or EngineConfig()
        algos.get(self.config.algorithm)  # validate early
        self.state = EngineState.IDLE
        self.stats = EngineStats(algorithm=self.config.algorithm)
        for name in backends:
            self.stats.devices[name] = DeviceStats()
        self._job: Job | None = None
        self._job_event = asyncio.Event()
        self._job_serial = 0
        self._tasks: list[asyncio.Task] = []
        self._stop = asyncio.Event()
        self._seen_shares: set[tuple[str, bytes, int, int]] = set()
        # in-flight device calls (executor future -> device name):
        # cancelling a searcher task does NOT stop its worker thread, so
        # teardown paths drain these (bounded by drain_timeout) before
        # closing the backends under them
        self._inflight: dict[asyncio.Future, str] = {}
        # per-call token shared with the executor wrapper: _abandon flips
        # it so a wedged call that finally lands — possibly after the
        # device reintegrated — never feeds its huge duration into the
        # EWMA and loosens the next deadline
        self._call_tokens: dict[asyncio.Future, dict] = {}
        # futures already given up on (watchdog timeout / drain timeout):
        # never re-counted, their late exceptions silenced
        self._abandoned_futs: set[asyncio.Future] = set()
        self._abandoned_calls = 0
        # per-device supervision: watchdog state machines + the searcher
        # relayout machinery that re-shards extranonce2 blocks over the
        # devices still eligible to mine
        self.supervisors: dict[str, DeviceSupervisor] = {}
        self._ensure_supervisors()
        self._relayout_event = asyncio.Event()
        self._layout_lock = asyncio.Lock()
        self._relayout_task: asyncio.Task | None = None
        self._relayouts = 0
        # device calls run on the ENGINE'S OWN executor, not the loop
        # default: an abandoned hung call wedges its worker thread (it
        # waits on the backend's stream, which nothing can cancel), and
        # wedged threads must starve only other device calls — never
        # job-constant builds or other work sharing the default pool
        # (created at start, replaced on restart; wedged threads of a
        # dead executor leak by design)
        self._device_executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._device_executor_size = 0
        # layout generation: bumped whenever the searcher set is torn
        # down. Loop conditions check it because task cancellation alone
        # is LOSABLE: wait_for can swallow a cancel that lands in the same
        # tick its awaited future completes, and a searcher that eats a
        # cancel would keep mining a stale extranonce2 layout
        self._layout_gen = 0
        self._switches = 0
        self._last_switch_downtime = 0.0

    # -- job intake ---------------------------------------------------------

    def set_job(self, job: Job) -> None:
        """Replace the current job. Clean jobs invalidate in-flight work
        (the searcher rechecks the serial between launch groups)."""
        if _canon_algo(job.algorithm) != _canon_algo(self.config.algorithm):
            # mining a mislabeled job would produce work every upstream
            # validator rejects — refuse loudly; the feed must follow the
            # engine's algorithm
            log.warning(
                "ignoring job %s: feed labels it %r but engine runs %r",
                job.job_id, job.algorithm, self.config.algorithm,
            )
            return
        old = self._job
        self._job = job
        self._job_serial += 1
        self.stats.current_job_id = job.job_id
        # forget the shares of older jobs, but not of the job replaced: its
        # in-flight calls still drain, and after a relayout they may cover
        # spaces whose shares were already emitted (a respawned searcher
        # starts its extranonce2 block again)
        kept = old.job_id if old is not None else None
        self._seen_shares = {k for k in self._seen_shares if k[0] == kept}
        self._job_event.set()
        log.debug("job %s set (clean=%s)", job.job_id, job.clean)

    # -- lifecycle ----------------------------------------------------------

    def _ensure_supervisors(self) -> None:
        for name in self.backends:
            if name not in self.supervisors:
                self.supervisors[name] = DeviceSupervisor(name, self.config)

    def _ensure_device_executor(self) -> None:
        """Size the device-call pool strictly above max_wedged_calls plus
        per-device pipeline headroom — a flapper wedging its way to the
        cap must leave every other device room to dispatch, and a queued
        dispatch must not age against its watchdog deadline. Re-checked
        on every membership change (switch/replace can GROW the backend
        set without a stop); growth swaps in a bigger pool and lets the
        old one's threads finish their in-flight calls."""
        needed = max(
            8,
            self.config.max_wedged_calls
            + len(self.backends) * (self.config.pipeline_depth + 2),
        )
        if (self._device_executor is not None
                and self._device_executor_size >= needed):
            return
        old = self._device_executor
        self._device_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=needed, thread_name_prefix="otedama-device",
        )
        self._device_executor_size = needed
        if old is not None:
            old.shutdown(wait=False)  # in-flight calls finish there

    async def start(self) -> None:
        if self.state == EngineState.RUNNING:
            return
        self.state = EngineState.STARTING
        self._stop.clear()
        self._relayout_event.clear()
        self._ensure_device_executor()
        self._ensure_supervisors()
        for name, sup in self.supervisors.items():
            # a restart is a fresh chance for every device STILL IN the
            # engine; DEAD tombstones of removed backends keep recording
            # their loss
            if name in self.backends:
                sup.reset_state()
        self._spawn_searchers()
        self._relayout_task = asyncio.get_running_loop().create_task(
            self._relayout_loop()
        )
        self.state = EngineState.RUNNING
        log.info("engine started with backends: %s", list(self.backends))

    def _spawn_searchers(self) -> None:
        loop = asyncio.get_running_loop()
        self._ensure_supervisors()
        # extranonce2 block layout: device i owns [sum(fanouts[:i]),
        # ...+fanout_i) and strides by the total. Only devices eligible to
        # mine take part: a quarantined/dead device's block is REASSIGNED
        # by the stride recomputation, so no extranonce2 space is orphaned
        # while it is out
        active = [
            (name, backend, getattr(backend, "en2_fanout", 1))
            for name, backend in self.backends.items()
            if self.supervisors[name].can_mine
        ]
        total_fanout = sum(f for _, _, f in active)
        gen = self._layout_gen
        offset = 0
        for name, backend, fanout in active:
            self._tasks.append(
                loop.create_task(
                    self._supervised_search(
                        name, backend, offset, total_fanout, gen
                    )
                )
            )
            offset += fanout
        # quarantined devices run their reintegration probe loop instead
        for name, backend in self.backends.items():
            sup = self.supervisors[name]
            if sup.state in (DeviceState.QUARANTINED, DeviceState.PROBING):
                sup.probe_interrupted()  # cancelled mid-probe: re-queue
                self._tasks.append(
                    loop.create_task(self._probe_loop(name, backend, gen))
                )

    async def _cancel_searchers(self) -> None:
        # bump FIRST: a task whose cancel gets swallowed (see _layout_gen)
        # still exits at its next generation check
        self._layout_gen += 1
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    def _request_relayout(self) -> None:
        """Ask the relayout loop to rebuild the searcher set over the
        currently-eligible devices (called from searcher/probe tasks,
        which cannot cancel themselves)."""
        self._relayout_event.set()

    async def _relayout_loop(self) -> None:
        """Membership changes (quarantine, reintegration, replacement)
        land here: cancel every searcher/probe task and respawn them
        under the recomputed extranonce2 layout — one batch boundary of
        downtime for the survivors, same cost as a warm swap."""
        while not self._stop.is_set():
            await self._relayout_event.wait()
            self._relayout_event.clear()
            if self._stop.is_set():
                return
            async with self._layout_lock:
                if self._stop.is_set() or self.state != EngineState.RUNNING:
                    continue
                await self._cancel_searchers()
                self._spawn_searchers()
                self._relayouts += 1
                states = {
                    name: self.supervisors[name].state.value
                    for name in self.backends
                }
                log.info("searcher layout rebuilt: %s", states)

    def _call_device_sync(self, name: str, key, fn, args, token):
        """Runs ON the executor thread: the ``device.call`` fault point
        (delay = hang on this very thread, error = backend crash,
        corrupt = wrong results past the backend's host re-check), then
        the real call, timed into the device's duration model — unless
        the call was abandoned meanwhile (its duration is a hang, not a
        model sample)."""
        directive = faults.hit("device.call", name, faults.DEVICE)
        t0 = time.monotonic()
        if directive is not None and directive.delay:
            directive.sleep_sync()
        result = fn(*args)
        # when the device's answer was in hand: the hashrate's clock (the
        # loop may drain the call much later, behind a share's submit)
        token["done_at"] = time.monotonic()
        sup = self.supervisors.get(name)
        if sup is not None and not token["abandoned"]:
            sup.observe_call(key, time.monotonic() - t0)
        if directive is not None and directive.corrupt:
            result = supervision.corrupt_result(result)
        return result

    def _run_device(self, loop, name: str, key, fn, *args):
        """Dispatch one device call to the executor through the
        supervision wrapper, tracked in ``_inflight`` so teardown can
        drain the worker thread. Returns ``(future, dispatched_at,
        watchdog_deadline, token)`` — the deadline is armed at DISPATCH
        time so pipelined calls age while queued behind their
        predecessors; the token carries the call's ``done_at``."""
        token = {"abandoned": False}
        fut = loop.run_in_executor(
            self._device_executor, self._call_device_sync,
            name, key, fn, args, token,
        )
        self._inflight[fut] = name
        self._call_tokens[fut] = token
        fut.add_done_callback(self._inflight_discard)
        # retrieve the exception of a call nobody awaits any more (its
        # searcher was cancelled by a relayout); an awaiting caller still
        # sees it
        fut.add_done_callback(self._silence)
        sup = self.supervisors.get(name)
        deadline = sup.deadline(key) if sup is not None else float("inf")
        return fut, time.monotonic(), deadline, token

    def _inflight_discard(self, fut) -> None:
        self._inflight.pop(fut, None)
        self._call_tokens.pop(fut, None)

    async def _await_call(self, name: str, fut, t0: float, deadline: float):
        """Await a device call under its watchdog deadline. A blown
        deadline abandons the future (the executor thread keeps running;
        its late result is discarded) and raises ``DeviceHungError``.
        The future is shielded: cancelling a searcher must not cancel it,
        or teardown could not wait for the thread."""
        if deadline == float("inf"):
            return await asyncio.shield(fut)
        remaining = deadline - (time.monotonic() - t0)
        try:
            return await asyncio.wait_for(
                asyncio.shield(fut), timeout=max(remaining, 0.05)
            )
        except asyncio.TimeoutError:
            sup = self.supervisors.get(name)
            if sup is not None:
                sup.watchdog_timeouts += 1
            self._abandon([fut])
            raise DeviceHungError(
                f"device {name}: call exceeded its {deadline:.2f}s "
                "watchdog deadline"
            ) from None

    @staticmethod
    def _silence(fut) -> None:
        fut.cancelled() or fut.exception()

    def _abandon(self, futures) -> int:
        """Stop waiting for device calls (watchdog/drain timeout): count
        each once, silence its eventual exception, leave the worker
        thread to finish into the void."""
        n = 0
        for fut in futures:
            if fut.done() or fut in self._abandoned_futs:
                continue
            self._abandoned_futs.add(fut)
            token = self._call_tokens.get(fut)
            if token is not None:
                token["abandoned"] = True
            fut.add_done_callback(self._abandoned_futs.discard)
            sup = self.supervisors.get(self._inflight.get(fut, ""))
            if sup is not None:
                sup.abandoned_calls += 1
            n += 1
        self._abandoned_calls += n
        return n

    async def _drain_inflight(self, futures, timeout: float | None = None) -> int:
        """Wait out still-running device calls (results discarded):
        closing a backend under a live ``search`` thread would free its
        scratch under the kernels. With a ``timeout``, calls still
        running past it are ABANDONED (returned count) — a wedged device
        must never hang shutdown or an algorithm switch. Calls abandoned
        EARLIER are already written off: waiting on them again would
        stall every later stop/switch for the full timeout."""
        pending = [
            f for f in futures
            if not f.done() and f not in self._abandoned_futs
        ]
        if not pending:
            return 0
        if timeout is None:
            await asyncio.gather(*pending, return_exceptions=True)
            return 0
        _, still_pending = await asyncio.wait(pending, timeout=timeout)
        return self._abandon(still_pending)

    async def _retire_backends(self, backends: dict, inflight,
                               context: str) -> None:
        """The one retire sequence every path that drops backends shares:
        drain the outgoing backends' in-flight calls bounded by
        drain_timeout, abandon (and log) what is still wedged, then close
        them."""
        abandoned = await self._drain_inflight(
            inflight, timeout=self.config.drain_timeout
        )
        if abandoned:
            log.warning(
                "%s: abandoned %d hung device call(s) past the %.1fs "
                "drain timeout; closing backends under them",
                context, abandoned, self.config.drain_timeout,
            )
        await self._close_backends(backends)

    async def _close_backends(self, backends: dict) -> None:
        # off the loop thread: a card backend's close waits (bounded) for
        # the kernels still queued on its stream before freeing its
        # scratch, and the event loop must keep serving meanwhile
        loop = asyncio.get_running_loop()
        for backend in backends.values():
            close = getattr(backend, "close", None)
            if close is not None:
                try:
                    await loop.run_in_executor(None, close)
                except Exception:
                    log.exception("backend %s close failed",
                                  getattr(backend, "name", "?"))

    async def stop(self) -> None:
        """Stop mining: cancel the searchers and drain their in-flight
        calls, abandoning those still running past ``drain_timeout``. The
        backends stay open — a recovery restart (stop, then start) mines
        on them again; ``close`` ends their life."""
        self.state = EngineState.STOPPING
        self._stop.set()
        self._job_event.set()
        self._relayout_event.set()  # wake the loop so cancel lands fast
        if self._relayout_task is not None:
            self._relayout_task.cancel()
            await asyncio.gather(self._relayout_task, return_exceptions=True)
            self._relayout_task = None
        await self._cancel_searchers()
        abandoned = await self._drain_inflight(
            list(self._inflight), timeout=self.config.drain_timeout
        )
        if abandoned:
            log.warning("stop: abandoned %d hung device call(s) past the "
                        "%.1fs drain timeout", abandoned,
                        self.config.drain_timeout)
        if self._device_executor is not None:
            # non-blocking: calls already abandoned past the drain stay
            # wedged on their threads; a restart builds a fresh pool
            self._device_executor.shutdown(wait=False, cancel_futures=True)
            self._device_executor = None
            self._device_executor_size = 0
        self.state = EngineState.STOPPED
        log.info("engine stopped")

    async def close(self) -> None:
        """Stop (when not stopped) and close every backend: the end of
        the engine's life. A card backend frees its device memory once
        the kernels queued on its stream have finished, and refuses any
        later call — an abandoned call that lands afterwards raises."""
        if self.state != EngineState.STOPPED:
            await self.stop()
        await self._close_backends(self.backends)

    # -- warm algorithm switching -------------------------------------------

    def planned_batch(self, backend) -> int:
        """The batch size the hot loop will dispatch to ``backend``: the
        configured batch, raised to the backend's ``preferred_batch`` under
        ``auto_batch``, and clamped to its ``max_batch`` (the slow
        algorithms' backends — scrypt, x11, ethash — cap one search call,
        so that a clean job strands seconds of stale work at most). Warm-swap
        precompiles warm exactly this shape."""
        batch_size = self.config.batch_size
        if self.config.auto_batch:
            batch_size = max(batch_size, getattr(backend, "preferred_batch", 0))
        max_batch = getattr(backend, "max_batch", None)
        if max_batch:
            batch_size = min(batch_size, max_batch)
        return batch_size

    async def switch_algorithm(
        self, algorithm: str, backends: dict[str, SearchBackendProtocol]
    ) -> float:
        """Atomic warm swap of the backend set (double-buffered switch).

        Callers build AND precompile ``backends`` first, off the event
        loop, while the current algorithm keeps mining
        (``AlgorithmManager.prepare_backend_async``) — so the only
        downtime this method pays is searcher teardown/spawn: one batch
        boundary, never a kernel build. Returns the measured downtime in
        seconds (old searchers cancelled -> new searchers spawned).
        """
        if not backends:
            raise ValueError("need at least one search backend")
        algos.get(algorithm)  # unknown algorithm fails before teardown
        _check_fanout(backends)
        was_running = self.state == EngineState.RUNNING
        old_backends = self.backends
        t0 = time.monotonic()
        async with self._layout_lock:  # a relayout mid-swap would respawn
            if was_running:            # searchers over the OLD backend set
                await self._cancel_searchers()
            # snapshot BEFORE spawning: only the old backends' device calls
            # must finish before those backends close; the new searchers
            # can dispatch meanwhile (the card runs both streams)
            old_inflight = [f for f in self._inflight if not f.done()]
            self.backends = backends
            if was_running:
                self._ensure_device_executor()  # the set may have GROWN
            self.config.algorithm = algorithm
            self.stats.algorithm = algorithm
            # drop departed devices: a stale EMA entry would keep inflating
            # the summed engine hashrate forever
            self.stats.devices = {
                name: self.stats.devices.get(name, DeviceStats())
                for name in backends
            }
            # same pruning for supervisors; persisting names keep their
            # state/counters, new devices start healthy — except DEAD
            # tombstones, which stay visible across switches
            new_sups = {
                name: self.supervisors.get(name)
                or DeviceSupervisor(name, self.config)
                for name in backends
            }
            for name, sup in self.supervisors.items():
                if name not in new_sups and sup.state is DeviceState.DEAD:
                    new_sups[name] = sup
            self.supervisors = new_sups
            job = self._job
            if job is not None and _canon_algo(job.algorithm) != _canon_algo(algorithm):
                # the old algorithm's job is meaningless to the new
                # backends; searchers idle on the job event until the new
                # feed delivers
                self._job = None
                self._job_serial += 1
                self._job_event.set()
            if was_running:
                self._spawn_searchers()
        downtime = time.monotonic() - t0
        self._switches += 1
        self._last_switch_downtime = downtime
        log.info(
            "engine switched to %s in %.3fs (backends: %s)",
            algorithm, downtime, list(backends),
        )
        # old backends close AFTER the new searchers are live — teardown
        # is not part of the downtime window — and only once their last
        # in-flight device call has drained (bounded: a wedged old device
        # must not stall the swap's cleanup forever)
        if old_backends is not backends:
            await self._retire_backends(
                old_backends, old_inflight, f"switch to {algorithm}"
            )
        return downtime

    # -- membership changes ---------------------------------------------------

    async def replace_backend(self, old_name: str, backend) -> None:
        """Swap ONE device's backend while the others keep mining.
        Callers precompile ``backend`` first (warm-swap rule); here it
        only costs the relayout batch boundary. The old backend's
        in-flight calls drain bounded by ``drain_timeout``, then it is
        closed."""
        _check_fanout({old_name: backend})
        new_name = getattr(backend, "name", old_name)
        async with self._layout_lock:
            was_running = self.state == EngineState.RUNNING
            if was_running:
                # tear down FIRST (bumps the layout generation): the old
                # device's probe loop must not dispatch a fresh call onto
                # a backend we are about to drain and close
                await self._cancel_searchers()
            old = self.backends.pop(old_name, None)
            self.backends[new_name] = backend
            if was_running:
                self._ensure_device_executor()
            self.supervisors.pop(old_name, None)  # fresh state machine
            if old_name != new_name:
                self.stats.devices.pop(old_name, None)
            self.stats.devices.setdefault(new_name, DeviceStats())
            self._ensure_supervisors()
            if was_running:
                self._spawn_searchers()
                self._relayouts += 1
        log.info("backend %s replaced by %s", old_name, new_name)
        if old is None:
            return
        old_inflight = [
            f for f, n in self._inflight.items() if n == old_name
        ]
        await self._retire_backends(
            {old_name: old}, old_inflight, f"replace of {old_name}"
        )

    async def remove_backend(self, name: str) -> None:
        """Drop a device permanently (e.g. DEAD after probe exhaustion).
        Its supervisor stays as a tombstone so the death remains
        observable; its extranonce2 block was already reassigned when the
        device left the mining set."""
        async with self._layout_lock:
            was_running = self.state == EngineState.RUNNING
            if was_running:
                # gen bump: the device's probe loop must not dispatch
                # onto the backend mid-drain (see replace_backend)
                await self._cancel_searchers()
            old = self.backends.pop(name, None)
            if old is not None:
                # drop the stats entry: its frozen hashrate EMA would
                # inflate the summed engine hashrate forever (the
                # supervisor tombstone keeps the death itself visible)
                self.stats.devices.pop(name, None)
            if was_running:
                self._spawn_searchers()
                self._relayouts += 1
        if old is None:
            return
        log.warning("backend %s removed from the engine", name)
        old_inflight = [f for f, n in self._inflight.items() if n == name]
        await self._retire_backends(
            {name: old}, old_inflight, f"removal of {name}"
        )

    # -- the hot host loop --------------------------------------------------

    async def _supervised_search(
        self, name: str, backend, en2_offset: int, en2_total: int, gen: int
    ) -> None:
        """Searcher supervisor: a blown watchdog deadline detaches the
        searcher and opens the device's quarantine; any other exception
        escaping the loop (backend crash) restarts it under capped
        backoff instead of silently killing the device while the engine
        reports "running"."""
        sup = self.supervisors[name]
        backoff = self.config.searcher_restart_backoff
        while not self._stop.is_set() and gen == self._layout_gen:
            started = time.monotonic()
            try:
                await self._search_loop(
                    name, backend, en2_offset, en2_total, gen
                )
                return  # stop requested or layout superseded
            except asyncio.CancelledError:
                raise
            except DeviceHungError as e:
                sup.on_hung(str(e))
                dstats = self.stats.devices.get(name)
                if dstats is not None:
                    # zero (not freeze) the EMA: a quarantined device
                    # mines nothing, and its frozen pre-hang rate would
                    # inflate the summed engine hashrate and mask
                    # HASHRATE_DROP detection for the outage's duration
                    dstats.hashrate = 0.0
                log.warning(
                    "device %s quarantined: %s (probing with backoff)",
                    name, e,
                )
                self._request_relayout()  # survivors re-shard its block
                return
            except Exception:
                sup.searcher_restarts += 1
                log.exception(
                    "searcher %s crashed (restart #%d)",
                    name, sup.searcher_restarts,
                )
                if (time.monotonic() - started
                        > 2 * self.config.searcher_restart_backoff_max):
                    backoff = self.config.searcher_restart_backoff
                await asyncio.sleep(backoff)
                backoff = min(
                    backoff * 2, self.config.searcher_restart_backoff_max
                )

    def _probe_search(self, backend):
        """One reintegration probe, on the executor thread (dispatched
        through the device.call wrapper so injected faults apply): re-run
        ``precompile`` — the card may have lost its loaded kernels with
        its state — then one easy-target batch whose results the caller
        verifies against the host oracle."""
        algorithm = getattr(backend, "algorithm", "sha256d")
        jc = supervision.probe_job_constants(algorithm)
        precompile = getattr(backend, "precompile", None)
        if precompile is not None:
            precompile(count=self.planned_batch(backend))
        count = self._probe_count(backend)
        base = supervision.PROBE_BASE
        results = backend.search(jc, base, count)
        return jc, results, base, count

    def _probe_count(self, backend) -> int:
        """Nonces in the verified probe batch (multi-device backends,
        ROADMAP A11, raise it to one tile of their own)."""
        return self.config.probe_count

    async def _probe_loop(self, name: str, backend, gen: int) -> None:
        """Reintegration probes for a quarantined device: exponential
        backoff, each probe deadline-bounded and host-oracle-verified;
        success closes the circuit and re-shards the device back in,
        ``max_probes`` consecutive failures mark it DEAD."""
        sup = self.supervisors[name]
        cfg = self.config
        loop = asyncio.get_running_loop()
        algorithm = getattr(backend, "algorithm", "sha256d")
        while not self._stop.is_set() and gen == self._layout_gen:
            try:
                await asyncio.wait_for(
                    self._stop.wait(), timeout=sup.next_probe_delay()
                )
                return  # stopping
            except asyncio.TimeoutError:
                pass
            if self._stop.is_set() or gen != self._layout_gen:
                return
            if cfg.max_wedged_calls:
                # abandoned calls STILL running wedge device-executor
                # threads; a flapping device (hang -> reintegrate -> hang)
                # accumulates one per incident. Past the cap it is DEAD —
                # reintegrating it again would bleed the executor dry. A
                # genuinely healed device's wedged calls finish and drop
                # the count back under the cap.
                wedged = sum(
                    1 for f, n in self._inflight.items()
                    if n == name and f in self._abandoned_futs
                )
                if wedged >= cfg.max_wedged_calls:
                    sup.mark_dead()
                    log.error(
                        "device %s marked DEAD: %d abandoned calls still "
                        "wedge executor threads (cap %d)",
                        name, wedged, cfg.max_wedged_calls,
                    )
                    return
            sup.begin_probe()
            probe_key = ("probe", self._probe_count(backend))
            # the incident's FIRST probe may pay a cold build that its
            # precompile step exists to absorb: give it the first-call
            # allowance rather than marking a healthy but slow device
            # DEAD. Later probes use the tight probe_timeout — a wedged
            # device pays the long deadline once, not max_probes times
            deadline = cfg.probe_timeout
            if sup.probes_failed == 0 and not sup.has_samples(probe_key):
                deadline = max(deadline, cfg.watchdog_first_deadline)
            fut, t0, _, _ = self._run_device(
                loop, name, probe_key, self._probe_search, backend,
            )
            error = None
            try:
                jc, results, base, count = await self._await_call(
                    name, fut, t0, deadline
                )
                ok = await loop.run_in_executor(
                    None, supervision.verify_probe_results,
                    algorithm, jc, results, base, count,
                )
                if not ok:
                    error = "probe results failed host-oracle verification"
            except asyncio.CancelledError:
                raise
            except DeviceHungError as e:
                error = str(e)
            except Exception as e:
                error = repr(e)
            if error is None:
                sup.reintegrate()
                log.info(
                    "device %s reintegrated after %d probe(s)",
                    name, sup.probes,
                )
                self._request_relayout()
                return
            sup.probe_failed(error)
            log.warning("device %s probe failed: %s", name, error)
            if cfg.max_probes and sup.probes_failed >= cfg.max_probes:
                sup.mark_dead()
                log.error(
                    "device %s marked DEAD after %d consecutive failed "
                    "probes", name, sup.probes_failed,
                )
                return

    async def _search_loop(
        self, name: str, backend, en2_offset: int, en2_total: int,
        gen: int | None = None,
    ) -> None:
        loop = asyncio.get_running_loop()
        if gen is None:
            gen = self._layout_gen
        dstats = self.stats.devices.setdefault(name, DeviceStats())
        # a changed job's calls still in flight, as (job, pending): they
        # drain once the next job's first call is on the stream behind
        # them. Drained first (as the reference does), the card would
        # idle from the last of them to the next job's first launch, for
        # as long as the event loop took to get there
        carried = None
        while not self._stop.is_set() and gen == self._layout_gen:
            job = self._job
            if job is None or job.is_expired(self.config.job_max_age):
                if carried is not None:
                    await self._drain_calls(name, *carried, dstats)
                    carried = None
                self._job_event.clear()
                try:
                    await asyncio.wait_for(self._job_event.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue

            serial = self._job_serial
            # extranonce2 spaces a call consumes (1 until multi-device
            # backends, ROADMAP A11); devices own disjoint blocks laid out
            # by _spawn_searchers
            fanout = getattr(backend, "en2_fanout", 1)
            batch_size = self.planned_batch(backend)
            depth = max(1, self.config.pipeline_depth)
            extranonce = ExtranonceCounter(
                size=job.extranonce2_size or self.config.extranonce2_size)
            extranonce.value = en2_offset
            # grouped dispatch: `depth` launches per executor call, all
            # issued before the group's one read-back; two groups in
            # flight. Other backends keep `depth` single searches in
            # flight. Tuples are (en2s, future, dispatched_at,
            # watchdog_deadline, token), drained in dispatch order.
            grouped = hasattr(backend, "search_group")
            pend_cap = min(2, depth) if grouped else depth
            pending: list[tuple] = []
            # the hashrate's clock runs from call to call for the whole
            # searcher: the reference restarts it at each extranonce2
            # roll, after the host hop below, so a call that finished
            # during a slow hop sampled its hashes over milliseconds
            t_last = time.monotonic()
            try:
                while (not self._stop.is_set() and serial == self._job_serial
                       and gen == self._layout_gen):
                    en2s = [extranonce.current()]
                    for _ in range(fanout - 1):
                        en2s.append(extranonce.roll())
                    jcs = await loop.run_in_executor(
                        None, _job_constants_batch, job, en2s
                    )
                    batches = iter(NonceRange(0, 1 << 32).batches(batch_size))
                    unit_size = depth if grouped else 1
                    for unit in iter(
                            lambda: list(itertools.islice(batches, unit_size)),
                            []):
                        if (self._stop.is_set()
                                or serial != self._job_serial
                                or gen != self._layout_gen):
                            break
                        # fault point engine.batch: delay stalls batch
                        # completion (the FailureDetector must notice and
                        # recover), error kills this searcher like a
                        # backend crash would, drop skips the unit
                        fd = faults.hit("engine.batch", name, faults.STEP)
                        if fd is not None:
                            if fd.delay:
                                await asyncio.sleep(fd.delay)
                            if fd.drop:
                                continue
                        if grouped:
                            # the watchdog key: the group's lane count
                            fut, t0, dl, token = self._run_device(
                                loop, name, sum(c for _, c in unit),
                                backend.search_group, jcs[0], unit,
                            )
                        else:
                            base, count = unit[0]
                            fut, t0, dl, token = self._run_device(
                                loop, name, count,
                                backend.search, jcs[0], base, count,
                            )
                        pending.append((en2s, fut, t0, dl, token))
                        if carried is not None:
                            done_at = await self._drain_calls(
                                name, *carried, dstats)
                            carried = None
                            t_last = max(t_last, done_at)
                        if len(pending) >= pend_cap:
                            p_en2s, p_fut, p_t0, p_dl, p_token = pending.pop(0)
                            results = await self._await_call(
                                name, p_fut, p_t0, p_dl
                            )
                            t_last = await self._consume(
                                job, p_en2s, results, dstats, t_last,
                                p_token["done_at"], p_t0, pend_cap,
                            )
                    else:
                        # nonce spaces exhausted: stride to this device's
                        # next extranonce2 block (the counter sits at
                        # block start + fanout - 1)
                        for _ in range(en2_total - fanout + 1):
                            extranonce.roll()
                        continue
                    break  # job changed or stopping
                if carried is not None:
                    # the job changed again before its first call: the
                    # older job's calls drain first
                    await self._drain_calls(name, *carried, dstats)
                    carried = None
                if not self._stop.is_set() and gen == self._layout_gen:
                    carried, pending = (job, pending), []
                else:
                    await self._drain_calls(name, job, pending, dstats)
            except Exception:
                # hung OR crashed: nothing will await what this pipeline
                # still has in flight — count it abandoned (the executor
                # threads run on; late results are discarded), then let
                # the supervisor decide quarantine vs restart.
                # Cancellation is NOT abandonment: stop()/switch drain
                # those futures properly.
                if carried is not None:
                    pending = carried[1] + pending
                self._abandon([p[1] for p in pending])
                raise
        if carried is not None:
            await self._drain_calls(name, *carried, dstats)

    async def _drain_calls(self, name: str, job: Job, pending: list,
                           dstats) -> float:
        """Consume a job's calls still in flight, in dispatch order:
        winners of an already-running launch are valid shares for it, so
        a call that failed is logged and skipped, and the calls behind it
        are still consumed; a hung one abandons the calls behind it and
        detaches the searcher (``DeviceHungError``). Returns when the last
        call's answer was in hand (0.0 for none)."""
        done_at = 0.0
        for i, (p_en2s, p_fut, p_t0, p_dl, p_token) in enumerate(pending):
            try:
                results = await self._await_call(name, p_fut, p_t0, p_dl)
            except DeviceHungError:
                self._abandon([p[1] for p in pending[i + 1:]])
                raise
            except Exception:
                log.exception("in-flight search failed during drain")
                continue
            done_at = p_token["done_at"]
            await self._consume(job, p_en2s, results, dstats, None, done_at,
                                p_t0, len(pending))
        return done_at

    async def _consume(
        self, job: Job, en2s: list[bytes], results, dstats,
        t_last: float | None, done_at: float, dispatched_at: float,
        in_flight: int,
    ) -> float:
        """Account one drained device call and emit its shares.

        ``results`` is one SearchResult (plain), or a list of same-en2
        slices (grouped backends); ``done_at`` is when its answer was in
        hand. The hashrate sample is the call's hashes over the time
        since ``t_last``, the previous call's ``done_at`` (the searcher's
        start for its first call): the reference times it from the drain,
        restarted at each extranonce2 roll, so a call drained just after
        a slow host hop sampled a rate of hundreds of GH/s, and the
        failure detector restarted a healthy engine below a quarter of
        that peak. Nor is that time shorter than the call's own since its
        dispatch (``dispatched_at``) shared among the ``in_flight`` calls
        the searcher keeps: a device whose calls overlap (ethash's light
        and full tiers, each on a stream of its own) can answer two calls
        milliseconds apart, and their gap alone sampled tens of times the
        card's rate. Returns the new t_last.
        """
        if not isinstance(results, list):
            results = [results]
        hashes = sum(r.hashes for r in results)
        seconds = 0.0 if t_last is None else max(
            done_at - t_last, (done_at - dispatched_at) / in_flight)
        dstats.record_batch(hashes, seconds)
        self.stats.hashes += hashes
        for result in results:
            await self._emit_shares(job, en2s[0], result)
        return done_at

    async def _emit_shares(self, job: Job, en2: bytes, result: SearchResult) -> None:
        for w in result.winners:
            key = (job.job_id, en2, job.ntime, w.nonce_word)
            if key in self._seen_shares:
                continue
            self._seen_shares.add(key)
            diff = tgt.difficulty_of_digest(w.digest)
            share = Share(
                job_id=job.job_id,
                worker=self.config.worker_name,
                extranonce2=en2,
                ntime=job.ntime,
                nonce_word=w.nonce_word,
                digest=w.digest,
                difficulty=diff,
                algorithm=job.algorithm,
            )
            self.stats.shares_found += 1
            self.stats.best_difficulty = max(self.stats.best_difficulty, diff)
            if tgt.hash_meets_target(w.digest, tgt.bits_to_target(job.nbits)):
                self.stats.blocks_found += 1
                log.info("BLOCK candidate found: job=%s nonce=%s",
                         job.job_id, w.nonce_hex)
            if self.on_share is not None:
                await self.on_share(share)

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["state"] = self.state.value
        snap["switches"] = self._switches
        snap["last_switch_downtime_seconds"] = round(
            self._last_switch_downtime, 6
        )
        # device supervision: per-device state machine + counters ride the
        # same per-device dict operators already read hashrates from
        for name, sup in self.supervisors.items():
            entry = snap["devices"].setdefault(name, {})
            entry.update(sup.snapshot())
        snap["abandoned_calls"] = self._abandoned_calls
        snap["relayouts"] = self._relayouts
        snap["supervision"] = self.device_health()
        inj = faults.get()
        if inj is not None:
            # chaos runs are observable where operators already look:
            # per-point hit/fault counters ride the engine snapshot
            snap["fault_injection"] = inj.snapshot()
        return snap

    def device_health(self) -> dict:
        """Readiness summary: serving-but-degraded (capacity lost to
        quarantine/death but survivors mining) is distinct from unready
        (running with NO device able to mine)."""
        states = {
            name: self.supervisors[name].state.value
            for name in self.backends
            if name in self.supervisors
        }
        # DEAD tombstones of removed backends stay visible
        for name, sup in self.supervisors.items():
            if name not in states and sup.state is DeviceState.DEAD:
                states[name] = sup.state.value
        active = sum(
            1 for name in self.backends
            if name in self.supervisors and self.supervisors[name].can_mine
        )
        impaired = [
            name for name, state in states.items()
            if state not in ("healthy", "suspect")
        ]
        if self.state in (EngineState.STOPPED, EngineState.ERROR):
            # a stopped engine serves nothing — e.g. a recovery restart
            # whose start() failed (IDLE/STARTING are planned startup:
            # the precompile is in flight)
            status = "unready"
        elif (self.state == EngineState.RUNNING and self.backends
                and active == 0):
            status = "unready"
        elif impaired:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "active_devices": active,
            "total_devices": len(self.backends),
            "device_states": states,
        }
