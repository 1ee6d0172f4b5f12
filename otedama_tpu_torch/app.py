"""Application composition root + lifecycle, solo mode (counterpart of
``otedama_tpu/app.py``: ``_build_engine``, ``_on_share``, the chain branch
of ``_start_miner_side``, precompile-then-start, ``stop``, ``snapshot``).

Solo: the engine mines jobs from a ``TemplateSource`` polling a chain
client, and every share that meets the network target is submitted to
the chain as a block. The pool, stratum, p2p and API tiers of the
reference are not ported yet.
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
from otedama_tpu_torch.pool.blockchain import MockChainClient
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
        log.info("application started (solo mining: %s)",
                 self.config.mining.enabled)

    async def _start_miner_side(self) -> None:
        cfg = self.config
        if self.chain is None:
            if cfg.pool.chain_rpc_url:
                raise ValueError(
                    "pool.chain_rpc_url is set, but this package has no chain "
                    "RPC client yet; unset it to mine against the mock chain"
                )
            self.chain = MockChainClient()
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
        log.info("application stopped")

    def snapshot(self) -> dict:
        out = {"uptime_seconds": round(time.time() - self.started_at, 1)}
        if self.engine is not None:
            out["engine"] = self.engine.snapshot()
        if self.worksource is not None:
            out["worksource"] = self.worksource.snapshot()
        return out
