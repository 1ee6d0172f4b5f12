"""The mining engine: async orchestration of device search (counterpart of
``otedama_tpu/engine/engine.py``).

One async searcher per device backend keeps the card fed, rolls
extranonce2 spaces and pumps found shares to the submit callback:

  current job -> (extranonce2, ntime) -> JobConstants (host midstate) ->
  backend.search_group(launches) in an executor thread -> winners ->
  Share -> on_share

Device supervision (watchdog, quarantine, probes, relayout), warm
algorithm switching and the fault points of the reference engine are not
ported yet; a searcher whose loop raises is restarted under capped
backoff.
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
from otedama_tpu_torch.runtime.partition import ExtranonceCounter, NonceRange
from otedama_tpu_torch.runtime.search import JobConstants, SearchResult

log = logging.getLogger("otedama.engine")

ShareCallback = Callable[[Share], Awaitable[None]]


def _canon_algo(name: str) -> str:
    """Canonical algorithm identity: aliases resolve through the registry
    and the sha256 family collapses to one name (``make_backend`` routes
    both to the same kernel)."""
    try:
        name = algos.get(name).name
    except KeyError:
        pass  # unknown names compare as themselves (and mismatch loudly)
    return "sha256d" if name == "sha256" else name


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
    # stop() waits at most this long for in-flight device calls
    drain_timeout: float = 30.0
    searcher_restart_backoff: float = 0.5
    searcher_restart_backoff_max: float = 30.0


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
        # in-flight device calls: cancelling a searcher does not stop its
        # executor thread, so stop() drains these before returning
        self._inflight: set[asyncio.Future] = set()
        self._device_executor: concurrent.futures.ThreadPoolExecutor | None = None
        self.searcher_restarts = 0

    # -- job intake ---------------------------------------------------------

    def set_job(self, job: Job) -> None:
        """Replace the current job. Clean jobs invalidate in-flight work
        (the searcher rechecks the serial between launch groups)."""
        if _canon_algo(job.algorithm) != _canon_algo(self.config.algorithm):
            log.warning(
                "ignoring job %s: feed labels it %r but engine runs %r",
                job.job_id, job.algorithm, self.config.algorithm,
            )
            return
        self._job = job
        self._job_serial += 1
        self.stats.current_job_id = job.job_id
        self._seen_shares.clear()
        self._job_event.set()
        log.debug("job %s set (clean=%s)", job.job_id, job.clean)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self.state == EngineState.RUNNING:
            return
        self.state = EngineState.STARTING
        self._stop.clear()
        self._device_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, len(self.backends) * (self.config.pipeline_depth + 2)),
            thread_name_prefix="otedama-device",
        )
        loop = asyncio.get_running_loop()
        # extranonce2 layout: device i starts at value i and strides by the
        # device count, so devices never search the same header
        total = len(self.backends)
        for offset, (name, backend) in enumerate(self.backends.items()):
            self._tasks.append(loop.create_task(
                self._searcher(name, backend, offset, total)))
        self.state = EngineState.RUNNING
        log.info("engine started with backends: %s", list(self.backends))

    async def stop(self) -> None:
        self.state = EngineState.STOPPING
        self._stop.set()
        self._job_event.set()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        pending = [f for f in self._inflight if not f.done()]
        if pending:
            _, still = await asyncio.wait(pending,
                                          timeout=self.config.drain_timeout)
            if still:
                log.warning("stop: %d device call(s) still running past the "
                            "%.1fs drain timeout", len(still),
                            self.config.drain_timeout)
        if self._device_executor is not None:
            self._device_executor.shutdown(wait=False, cancel_futures=True)
            self._device_executor = None
        self.state = EngineState.STOPPED
        log.info("engine stopped")

    def planned_batch(self, backend) -> int:
        """The batch size the hot loop will dispatch to ``backend``: the
        configured batch, raised to the backend's ``preferred_batch`` under
        ``auto_batch``, and clamped to its ``max_batch`` (the scrypt
        backends cap one search call at four chunks)."""
        batch_size = self.config.batch_size
        if self.config.auto_batch:
            batch_size = max(batch_size, getattr(backend, "preferred_batch", 0))
        max_batch = getattr(backend, "max_batch", None)
        if max_batch:
            batch_size = min(batch_size, max_batch)
        return batch_size

    # -- the hot host loop --------------------------------------------------

    def _run_device(self, loop, fn, *args) -> asyncio.Future:
        """Dispatch one device call to the engine's executor. Callers
        await it through ``asyncio.shield``: cancelling a searcher must not
        cancel the future, or stop() could not wait for the thread."""
        fut = loop.run_in_executor(self._device_executor, fn, *args)
        self._inflight.add(fut)
        fut.add_done_callback(self._inflight.discard)
        # retrieve the exception of a call nobody awaits any more (its
        # searcher was cancelled); an awaiting caller still sees it
        fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        return fut

    async def _searcher(self, name: str, backend, en2_offset: int,
                        en2_total: int) -> None:
        """Runs the search loop; a loop that dies to a backend exception
        restarts under capped backoff instead of silently vanishing."""
        backoff = self.config.searcher_restart_backoff
        while not self._stop.is_set():
            try:
                await self._search_loop(name, backend, en2_offset, en2_total)
                return
            except asyncio.CancelledError:
                raise
            except Exception:
                self.searcher_restarts += 1
                log.exception("searcher %s crashed (restart #%d)", name,
                              self.searcher_restarts)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2,
                              self.config.searcher_restart_backoff_max)

    async def _search_loop(self, name: str, backend, en2_offset: int,
                           en2_total: int) -> None:
        loop = asyncio.get_running_loop()
        dstats = self.stats.devices.setdefault(name, DeviceStats())
        while not self._stop.is_set():
            job = self._job
            if job is None or job.is_expired(self.config.job_max_age):
                self._job_event.clear()
                try:
                    await asyncio.wait_for(self._job_event.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue

            serial = self._job_serial
            batch_size = self.planned_batch(backend)
            depth = max(1, self.config.pipeline_depth)
            extranonce = ExtranonceCounter(
                size=job.extranonce2_size or self.config.extranonce2_size)
            extranonce.value = en2_offset
            # grouped dispatch: `depth` launches per executor call, all
            # issued before the group's one read-back; two groups in
            # flight. Other backends keep `depth` single searches in flight.
            grouped = hasattr(backend, "search_group")
            pend_cap = min(2, depth) if grouped else depth
            # (en2, future) in dispatch order; drained in order
            pending: list[tuple[bytes, asyncio.Future]] = []
            while not self._stop.is_set() and serial == self._job_serial:
                en2 = extranonce.current()
                jc = await loop.run_in_executor(None, job_constants, job, en2)
                t_last = time.monotonic()
                batches = iter(NonceRange(0, 1 << 32).batches(batch_size))
                unit_size = depth if grouped else 1
                for unit in iter(lambda: list(itertools.islice(batches, unit_size)), []):
                    if self._stop.is_set() or serial != self._job_serial:
                        break
                    if grouped:
                        fut = self._run_device(loop, backend.search_group, jc, unit)
                    else:
                        fut = self._run_device(loop, backend.search, jc, *unit[0])
                    pending.append((en2, fut))
                    if len(pending) >= pend_cap:
                        p_en2, p_fut = pending.pop(0)
                        t_last = await self._consume(
                            job, p_en2, await asyncio.shield(p_fut), dstats,
                            t_last)
                else:
                    # nonce space exhausted: stride to this device's next
                    # extranonce2 block
                    for _ in range(en2_total):
                        extranonce.roll()
                    continue
                break  # job changed or stopping
            # drain whatever is still in flight for this job: winners of an
            # already-running launch are valid shares for it, so a call that
            # failed is logged and skipped, and the calls behind it are
            # still consumed
            while pending:
                p_en2, p_fut = pending.pop(0)
                try:
                    results = await asyncio.shield(p_fut)
                except Exception:
                    log.exception("in-flight search failed during drain")
                    continue
                await self._consume(job, p_en2, results, dstats, None)

    async def _consume(self, job: Job, en2: bytes, results, dstats,
                       t_last: float | None) -> float:
        """Account one drained device call (one SearchResult, or a list of
        same-extranonce2 slices from a grouped call) and emit its shares.
        Returns the new t_last."""
        if not isinstance(results, list):
            results = [results]
        now = time.monotonic()
        hashes = sum(r.hashes for r in results)
        dstats.record_batch(hashes, 0.0 if t_last is None else now - t_last)
        self.stats.hashes += hashes
        for result in results:
            await self._emit_shares(job, en2, result)
        return now

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
        snap["searcher_restarts"] = self.searcher_restarts
        return snap
