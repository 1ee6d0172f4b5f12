"""TemplateSource: local block templates as the job source of a solo
miner or of the pool (counterpart of ``otedama_tpu/work/template.py``
without merged mining).

One template's life:

1. poll ``get_block_template`` on the chain client;
2. validate it — an impossible template (height/prev/nbits/ntime) is
   rejected loudly and the last good job keeps serving;
3. adopt the node's coinbase halves (mock/regtest nodes ship them) or
   build a real coinbase around the payout script: BIP34 height push,
   pool tag, and an extranonce gap of ``extranonce1_len +
   extranonce2_size`` bytes between the halves;
4. emit a ``Job`` to every sink: ``clean=True`` on a new tip,
   ``clean=False`` on a same-height refresh (a template race). With a
   ``pool`` the job comes from ``PoolManager.job_from_template``, which
   keeps the template's reward for the block's distribution.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import logging
import struct
import time

from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.pool.blockchain import BlockTemplate

log = logging.getLogger("otedama.work.template")

# bitcoin consensus: coinbase scriptSig length in [2, 100]
_MAX_SCRIPTSIG = 100


def _varint(n: int) -> bytes:
    if n < 0xFD:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfd" + struct.pack("<H", n)
    return b"\xfe" + struct.pack("<I", n)


def _push(data: bytes) -> bytes:
    if len(data) >= 0x4C:
        raise ValueError("script push too long for a coinbase tag")
    return bytes([len(data)]) + data


def _push_height(height: int) -> bytes:
    """BIP34: the block height as a minimal script number push."""
    if height == 0:
        return b"\x00"
    out = b""
    n = height
    while n:
        out += bytes([n & 0xFF])
        n >>= 8
    if out[-1] & 0x80:
        out += b"\x00"
    return _push(out)


def build_coinbase_halves(height: int, reward: int, payout_script: bytes,
                          tag: bytes, extranonce_gap: int) -> tuple[bytes, bytes]:
    """A real coinbase transaction split around the extranonce gap: coinb1
    ends where extranonce1 begins and coinb2 starts right after
    extranonce2 — the contract stratum's ``mining.notify`` halves obey."""
    prefix = _push_height(height) + (_push(tag) if tag else b"")
    script_len = len(prefix) + extranonce_gap
    if script_len > _MAX_SCRIPTSIG:
        raise ValueError(f"coinbase scriptSig {script_len} > {_MAX_SCRIPTSIG}")
    coinb1 = (
        struct.pack("<I", 1)                    # tx version
        + b"\x01"                               # one input
        + b"\x00" * 32 + b"\xff\xff\xff\xff"    # null prevout
        + _varint(script_len) + prefix
    )
    coinb2 = (
        b"\xff\xff\xff\xff"                   # sequence
        + b"\x01"                               # one output
        + struct.pack("<q", reward)
        + _varint(len(payout_script)) + payout_script
        + struct.pack("<I", 0)                  # locktime
    )
    return coinb1, coinb2


class TemplateSource:
    """Polls a chain node and originates jobs (docstring at module top)."""

    def __init__(self, chain, *, pool=None, algorithm: str = "sha256d",
                 poll_seconds: float = 2.0, extranonce1_len: int = 4,
                 extranonce2_size: int = 4, payout_script: bytes = b"",
                 coinbase_tag: bytes = b"/otedama/"):
        self.chain = chain
        self.pool = pool                    # PoolManager (reward bookkeeping)
        self.algorithm = algorithm
        self.poll_seconds = poll_seconds
        self.extranonce1_len = extranonce1_len
        self.extranonce2_size = extranonce2_size
        self.payout_script = payout_script
        self.coinbase_tag = coinbase_tag
        self._sinks: list = []              # fn(job, clean) fan-out
        self._jobs: dict[str, Job] = {}
        self._counter = itertools.count(1)
        self._last_tip: tuple[int, bytes] | None = None
        self._last_sig: tuple | None = None
        self._template_at = 0.0
        self.stats = {
            "templates_fetched": 0, "templates_rejected": 0,
            "rpc_failures": 0, "jobs_emitted": 0, "clean_jobs": 0,
            "race_refreshes": 0, "template_height": 0,
            "last_refresh_seconds": 0.0,
        }

    def add_sink(self, fn) -> None:
        """Register a ``fn(job, clean)`` consumer."""
        self._sinks.append(fn)

    def get_job(self, job_id: str) -> Job | None:
        return self._jobs.get(job_id)

    @staticmethod
    def _validate(t: BlockTemplate) -> str | None:
        if t.height < 0:
            return "height"
        if len(t.prev_hash) != 32:
            return "prev-hash"
        if t.nbits == 0 or tgt.bits_to_target(t.nbits) <= 0:
            return "nbits"
        if t.ntime <= 0:
            return "ntime"
        return None

    def _assemble(self, t: BlockTemplate) -> tuple[bytes, bytes]:
        if t.coinb1:
            return t.coinb1, t.coinb2
        gap = self.extranonce1_len + self.extranonce2_size
        return build_coinbase_halves(
            t.height, t.reward, self.payout_script, self.coinbase_tag, gap)

    async def poll_once(self) -> Job | None:
        """One template fetch -> at most one emitted job."""
        t0 = time.monotonic()
        try:
            t = await self.chain.get_block_template()
        except Exception as exc:
            self.stats["rpc_failures"] += 1
            log.warning("template fetch failed: %s — last good job serves on",
                        exc)
            return None
        self.stats["templates_fetched"] += 1
        reason = self._validate(t)
        if reason is not None:
            self.stats["templates_rejected"] += 1
            log.warning("template rejected (%s): height=%d — last good job "
                        "serves on", reason, t.height)
            return None
        coinb1, coinb2 = self._assemble(t)
        sig = (t.height, t.prev_hash, coinb1, coinb2,
               tuple(t.merkle_branch), t.nbits)
        if sig == self._last_sig:
            self._template_at = time.time()
            return None
        clean = self._last_tip != (t.height, t.prev_hash)
        job = self._emit(t, coinb1, coinb2, clean)
        self._last_sig = sig
        self._last_tip = (t.height, t.prev_hash)
        self._template_at = time.time()
        self.stats["template_height"] = t.height
        self.stats["last_refresh_seconds"] = time.monotonic() - t0
        return job

    def _emit(self, t: BlockTemplate, coinb1: bytes, coinb2: bytes,
              clean: bool) -> Job:
        if self.pool is not None:
            job = self.pool.job_from_template(
                dataclasses.replace(t, coinb1=coinb1, coinb2=coinb2),
                algorithm=self.algorithm)
            job.clean = clean
        else:
            job = Job(
                job_id=f"tmpl-{next(self._counter):x}",
                prev_hash=t.prev_hash, coinb1=coinb1, coinb2=coinb2,
                merkle_branch=list(t.merkle_branch), version=t.version,
                nbits=t.nbits, ntime=t.ntime, clean=clean,
                algorithm=self.algorithm,
                extranonce2_size=self.extranonce2_size,
                block_number=t.height,
                share_target=tgt.bits_to_target(t.nbits),
            )
        self._jobs[job.job_id] = job
        if len(self._jobs) > 64:
            for jid in list(self._jobs)[:-32]:
                del self._jobs[jid]
        self.stats["jobs_emitted"] += 1
        if clean:
            self.stats["clean_jobs"] += 1
        else:
            self.stats["race_refreshes"] += 1
        for sink in self._sinks:
            sink(job, clean)
        log.info("work source emitted job %s height %d clean=%s",
                 job.job_id, t.height, clean)
        return job

    async def run(self) -> None:
        """The poll loop."""
        while True:
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # a bug here must not kill the job stream — count + carry on
                self.stats["rpc_failures"] += 1
                log.exception("template poll crashed; retrying")
            await asyncio.sleep(self.poll_seconds)

    def snapshot(self) -> dict:
        snap = dict(self.stats)
        snap["template_age_seconds"] = round(
            time.time() - self._template_at, 3) if self._template_at else -1.0
        return snap
