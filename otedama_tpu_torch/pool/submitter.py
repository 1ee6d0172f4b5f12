"""Block submission with retries, confirmation tracking, orphan detection
(counterpart of ``otedama_tpu/pool/submitter.py``).

Reference parity: internal/pool/block_submitter.go:17-81 (retry loop,
confirmation poller, orphan check).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging

from otedama_tpu_torch.db.repos import BlockRepository
from otedama_tpu_torch.pool.blockchain import BlockchainClient, SubmitOutcome
from otedama_tpu_torch.utils import faults

log = logging.getLogger("otedama.pool.submitter")


@dataclasses.dataclass
class SubmitterConfig:
    max_retries: int = 3
    retry_delay: float = 1.0
    confirm_poll_seconds: float = 30.0
    confirmations_required: int = 6


class BlockSubmitter:
    def __init__(
        self,
        chain: BlockchainClient,
        blocks: BlockRepository | None = None,
        config: SubmitterConfig | None = None,
        chain_name: str = "parent",
    ):
        self.chain = chain
        self.blocks = blocks
        self.config = config or SubmitterConfig()
        # which chain's rows this submitter owns: the confirmation sweep
        # must never poll the parent node for an aux chain's hashes (it
        # would answer -1 and falsely orphan them)
        self.chain_name = chain_name
        self._confirm_task: asyncio.Task | None = None

    async def submit(self, header: bytes, worker: str, reward: int = 0) -> SubmitOutcome:
        last = SubmitOutcome(False, reason="not attempted")
        for attempt in range(self.config.max_retries):
            try:
                # fault point inside the try: an injected RPC failure
                # takes the same retry path a real chain outage does
                d = faults.hit("pool.submitter.submit",
                               supports=faults.STEP)
                if d is not None:
                    if d.delay:
                        await asyncio.sleep(d.delay)
                    if d.drop:
                        raise ConnectionError("injected submit drop")
                last = await self.chain.submit_block(header)
            except Exception as e:
                last = SubmitOutcome(False, reason=str(e))
            if last.accepted:
                break
            # a definitive validation reject will not improve on retry
            if last.reason in ("high-hash", "bad header size", "duplicate"):
                break
            await asyncio.sleep(self.config.retry_delay * (attempt + 1))
        if self.blocks is not None and last.accepted:
            self.blocks.create(last.block_hash, worker, reward=reward,
                               chain=self.chain_name)
        if not last.accepted:
            log.warning("block submit failed for %s: %s", worker, last.reason)
        return last

    # -- confirmation tracking ----------------------------------------------

    def start_confirmation_tracking(self) -> None:
        if self._confirm_task is None:
            self._confirm_task = asyncio.get_running_loop().create_task(
                self._confirm_loop()
            )

    async def stop(self) -> None:
        if self._confirm_task is not None:
            self._confirm_task.cancel()
            try:
                await self._confirm_task
            except asyncio.CancelledError:
                pass
            self._confirm_task = None

    async def _confirm_loop(self) -> None:
        while True:
            await self.check_pending()
            await asyncio.sleep(self.config.confirm_poll_seconds)

    async def check_pending(self) -> None:
        if self.blocks is None:
            return
        for block in self.blocks.pending(chain=self.chain_name):
            try:
                confs = await self.chain.get_confirmations(block["hash"])
            except Exception as e:
                log.warning("confirmation check failed: %s", e)
                continue
            if confs < 0:
                self.blocks.set_status(block["hash"], "orphaned")
                log.warning("block %s orphaned", block["hash"][:16])
            elif confs >= self.config.confirmations_required:
                self.blocks.set_status(block["hash"], "confirmed", confs)
                log.info("block %s confirmed", block["hash"][:16])
            else:
                self.blocks.set_status(block["hash"], "pending", confs)
