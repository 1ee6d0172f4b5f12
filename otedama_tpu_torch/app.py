"""Application composition root + lifecycle, solo mode (counterpart of
``otedama_tpu/app.py``: ``_build_engine``, ``_on_share``, the chain branch
of ``_start_miner_side``, precompile-then-start, ``_start_supervision``,
``stop``, ``snapshot``).

Solo: the engine mines jobs from a ``TemplateSource`` polling a chain
client — the node named by ``pool.chain_rpc_url`` through
``BitcoinRPCClient``, else the in-process mock chain — and every share
that meets the network target is submitted to the chain as a block. A
``FailureDetector`` and a ``RecoveryManager`` supervise the engine. The
pool, stratum, p2p and API tiers of the reference are not ported yet.
"""

from __future__ import annotations

import asyncio
import logging
import time

from otedama_tpu_torch.config.schema import AppConfig
from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
from otedama_tpu_torch.engine.jobs import header_from_share
from otedama_tpu_torch.engine.types import Share
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.pool.blockchain import BitcoinRPCClient, MockChainClient
from otedama_tpu_torch.runtime.failure import (
    CallbackStrategy,
    FailureDetector,
    FailureType,
    RecoveryManager,
)
from otedama_tpu_torch.work.template import TemplateSource

log = logging.getLogger("otedama.app")


class Application:
    """``chain``: the chain client to mine against; None builds the one the
    config names (the in-process mock chain when ``pool.chain_rpc_url`` is
    unset)."""

    def __init__(self, config: AppConfig | None = None, *, chain=None):
        self.config = config or AppConfig()
        self.algo_manager = AlgorithmManager(self.config.mining.backend,
                                             device=self.config.mining.device)
        self.engine: MiningEngine | None = None
        self.chain = chain
        self.worksource: TemplateSource | None = None
        self.recovery: RecoveryManager | None = None
        self.failure_detector: FailureDetector | None = None
        # serialises engine restarts between the recovery manager and the
        # failure detector's strategies
        self._restart_lock = asyncio.Lock()
        self._tasks: list[asyncio.Task] = []
        self._started: list = []    # components in start order
        self.started_at = 0.0

    # -- construction ---------------------------------------------------------

    def _build_engine(self) -> MiningEngine:
        cfg = self.config.mining
        kwargs = {"winner_depth": cfg.winner_depth} if cfg.winner_depth else {}
        backend = self.algo_manager.backend_for(cfg.algorithm, **kwargs)
        return MiningEngine(
            backends={backend.name: backend},
            on_share=self._on_share,
            config=EngineConfig(
                worker_name=cfg.worker_name,
                algorithm=cfg.algorithm,
                batch_size=cfg.batch_size,
                pipeline_depth=cfg.pipeline_depth or EngineConfig.pipeline_depth,
                drain_timeout=cfg.drain_timeout,
                watchdog_multiplier=cfg.watchdog_multiplier,
                watchdog_floor=cfg.watchdog_floor,
                watchdog_first_deadline=cfg.watchdog_first_deadline,
                max_probes=cfg.max_probes,
            ),
        )

    async def _on_share(self, share: Share) -> None:
        """Solo: submit every share that meets the network target."""
        if self.engine is not None:
            self.engine.stats.shares_accepted += 1
        job = self.worksource.get_job(share.job_id)
        if job is None:
            return
        if not tgt.hash_meets_target(share.digest, tgt.bits_to_target(job.nbits)):
            return
        header = header_from_share(job, share.extranonce2, share.ntime,
                                   share.nonce_word)
        outcome = await self.chain.submit_block(header)
        if outcome.accepted:
            log.info("solo block accepted: %s", outcome.block_hash[:24])
        else:
            log.warning("solo block rejected: %s", outcome.reason)

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        self.started_at = time.time()
        if self.config.mining.enabled:
            await self._start_miner_side()
        await self._start_supervision()
        log.info("application started (solo mining: %s)",
                 self.config.mining.enabled)

    async def _start_miner_side(self) -> None:
        cfg = self.config
        if self.chain is None:
            self.chain = (
                BitcoinRPCClient(cfg.pool.chain_rpc_url,
                                 cfg.pool.chain_rpc_user,
                                 cfg.pool.chain_rpc_password)
                if cfg.pool.chain_rpc_url
                else MockChainClient()
            )
        self.engine = self._build_engine()
        source = TemplateSource(
            self.chain, algorithm=cfg.mining.algorithm,
            poll_seconds=cfg.work.poll_seconds if cfg.work.enabled else 5.0,
            # solo shares carry no extranonce1: the gap is extranonce2 alone
            extranonce1_len=0,
            payout_script=bytes.fromhex(cfg.work.payout_script),
            coinbase_tag=cfg.work.coinbase_tag.encode(),
        )
        source.add_sink(lambda job, clean: self.engine.set_job(job))
        self.worksource = source
        self._tasks.append(asyncio.create_task(source.run()))
        if cfg.mining.precompile:
            # build + warm in the background: the job feed comes up
            # meanwhile (early jobs buffer in set_job) and the engine
            # starts only when warm, so its first launch mines
            self._tasks.append(
                asyncio.create_task(self._precompile_then_start_engine()))
        else:
            await self.engine.start()
        self._started.append(self.engine)

    async def _precompile_then_start_engine(self) -> None:
        loop = asyncio.get_running_loop()
        engine = self.engine
        for backend in engine.backends.values():
            count = engine.planned_batch(backend)
            try:
                await loop.run_in_executor(
                    None, lambda b=backend, c=count: b.precompile(count=c))
            except Exception:
                # no fallback: a kernel that does not build or launch
                # leaves the engine stopped, loudly
                log.exception("precompile of %s failed; the engine will not "
                              "start", backend.name)
                raise
        await engine.start()

    async def _start_supervision(self) -> None:
        """Engine recovery (restart a dead engine) and the failure
        detector with its strategies, in the serve path."""
        self.recovery = RecoveryManager()
        if self.engine is not None:
            engine = self.engine
            lock = self._restart_lock

            async def engine_probe() -> bool:
                # transitional states are another supervisor's restart in
                # flight, not ill health; idle means the startup warmup
                # has not started the engine yet — "restarting" it would
                # start it cold
                return engine.state.value in (
                    "idle", "running", "starting", "stopping")

            async def engine_restart() -> None:
                async with lock:
                    if engine.state.value == "running":
                        return  # someone else already recovered it
                    await engine.stop()
                    await engine.start()

            self.recovery.register("engine", engine_probe, engine_restart)

            async def restart_engine_on_failure(failure) -> bool:
                # a hashrate drop / batch stall caused by capacity in
                # QUARANTINE belongs to the supervision layer (verified
                # probes): a blind restart would reset the wedged device
                # straight to HEALTHY and bypass oracle-verified
                # reintegration. DEAD is terminal, so a dead tombstone
                # does not stand this strategy down.
                states = engine.device_health()["device_states"]
                if any(s in ("quarantined", "probing")
                       for s in states.values()):
                    return False
                async with lock:
                    await engine.stop()
                    await engine.start()
                return True

            async def acknowledge_quarantine(failure) -> bool:
                """DEVICE_HUNG: the engine already quarantined the
                device, reassigned its extranonce2 block to the survivors
                and is probing for reintegration — report the failure
                handled."""
                sup = engine.supervisors.get(failure.component)
                return sup is not None and not sup.can_mine

            async def drop_dead_device(failure) -> bool:
                """DEVICE_LOST: drop the backend (closed under its
                tombstoned supervisor) as long as another device keeps
                mining."""
                sup = engine.supervisors.get(failure.component)
                if (sup is None or sup.state.value != "dead"
                        or failure.component not in engine.backends
                        or len(engine.backends) <= 1):
                    return False
                async with lock:
                    await engine.remove_backend(failure.component)
                return True

            self.failure_detector = FailureDetector(engine)
            for strategy in (
                CallbackStrategy(
                    "engine-restart",
                    (FailureType.BATCH_STALL, FailureType.HASHRATE_DROP),
                    restart_engine_on_failure),
                CallbackStrategy("device-quarantine",
                                 (FailureType.DEVICE_HUNG,),
                                 acknowledge_quarantine),
                CallbackStrategy("drop-dead-device",
                                 (FailureType.DEVICE_LOST,),
                                 drop_dead_device),
            ):
                self.failure_detector.add_strategy(strategy)
            await self.failure_detector.start()
            self._started.append(self.failure_detector)
        await self.recovery.start()
        self._started.append(self.recovery)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        results = await asyncio.gather(*self._tasks, return_exceptions=True)
        for r in results:
            if isinstance(r, Exception):
                log.error("background task failed: %r", r)
        self._tasks.clear()
        for component in reversed(self._started):
            try:
                await component.stop()
            except Exception:
                log.exception("stopping %s failed", type(component).__name__)
        self._started.clear()
        if self.engine is not None:
            # the end of the engine's life: its card backends free their
            # device memory
            await self.engine.close()
        close = getattr(self.chain, "close", None)
        if close is not None:
            close()  # release pooled keep-alive RPC sockets
        log.info("application stopped")

    def snapshot(self) -> dict:
        out = {"uptime_seconds": round(time.time() - self.started_at, 1)}
        if self.engine is not None:
            out["engine"] = self.engine.snapshot()
        if self.worksource is not None:
            out["worksource"] = self.worksource.snapshot()
        if self.failure_detector is not None:
            out["failures"] = self.failure_detector.snapshot()
        if self.recovery is not None:
            out["recovery"] = self.recovery.snapshot()
        return out
