#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Builds the port's kernels from the sources in this checkout (one nvcc per
source, started together), drives the solo sha256d, scrypt, x11 and ethash
main paths, the pool ledger's share validation (sha256d, scrypt, x11,
ethash), the
supervised engine, warm algorithm switching, the chain RPC client, the
stratum pool and client (pool mode with local mining, vardiff, upstream
failover, a scrypt pool) and the P2P share-chain pool with PostgreSQL
books through the entry points a user calls, and checks every phase; any
failure exits non-zero.
Phases:

1. card: name, power limit, clocks, versions; build the kernels; the
   registers and spills of the hot kernels (``-Xptxas -v``) and their hot
   loops' SASS by integer pipe (``cuobjdump -sass``); every B6 kernel's
   registers, spills, stack and resident warps an SM (none may spill or
   keep a stack); B6's instructions a lane by stage and pipe, from the
   SASS of its counting build; B7's kernels' registers, local memory,
   stack and warps (none may spill or keep a stack) and SASS by pipe;
2. known answer: the bitcoin genesis block's nonce wins a 2^20 window;
3. kernel against the plain PyTorch version on the card, buffer for buffer
   (few winners, target at a lane's hash and +-1, ragged counts — 1, 3,
   one past a multiple of the block's nonce tile, 2^20 + 77 —, a window
   that wraps 2^32, an empty window, table overflow, the backend's
   bisecting overflow rescan, and the main path's 2^31-lane launch);
4. main path: ``Application`` in solo mode on the card against a
   difficulty-1 mock chain until it accepts 3 blocks and 5 s have
   passed (its rate from the engine's start to the 3rd block, over the
   whole window, and steady between drained calls), through the
   engine's default 2^31-nonce grouped launches; every block is re-hashed
   with hashlib, the kernel must have launched and the plain version not;
5. times: the kernel's time per 2^31-nonce launch (CUDA events, after
   warm-up) beside its bound, with the SM clock and power draw sampled,
   and over 12 distinct difficulty-1 jobs (about half hold a winner);
6. scrypt known answer: digests of a fixed header through the ROMix
   kernel, and the whole search kernel path's winners, against
   hashlib.scrypt;
7. scrypt BlockMix kernels B3 and B4 against the plain version at the
   main path's shape [32, chunk];
8. scrypt ROMix kernel B5 against the plain version, full V and half_v,
   at the main path's shape and at 2^18 - 5, 4,099, 37 and 1 lanes;
9. scrypt search buffers against the plain version (n <= k: every word;
   n > k: count and min; a clamp at ``last`` mid-chunk; a base near 2^32;
   a scratch off the card refused before any launch);
10. scrypt main path: ``Application`` in solo mode with
   ``mining.algorithm = "scrypt"`` on the card for a fixed window against
   a mock chain at nbits 0x1f00ffff (about one share per 2^16 hashes);
   every share re-hashes with hashlib.scrypt at or under its target, the
   ROMix kernel must have launched and the plain version not;
11. the ``blockmix`` tier (B3 and B4) gives the same winners as the
   ``romix`` tier for one chunk, and three searches in flight on one
   backend (sharing its V) give what they give one by one;
12. scrypt times per chunk (CUDA events, median of rounds) for the
   ``romix``, ``romix-half`` and ``blockmix`` tiers beside their bounds,
   with the SM clock and power draw sampled, and the ``romix`` tier at
   2^16 and 2^17 lanes;
13. share validation known answer: the genesis header through the verify
   kernel B2 passes at bits 0x1d00ffff and at its digest and fails one
   below; a boundary batch (targets v, v-1, v+1) against hashlib;
14. B2 against the plain version on the card: 1,024 and 2^20 lanes with
   one Byzantine share in three (k = 512 holds every failure at 1,024
   lanes; at 2^20 the k = 16 table overflows and the count and min are
   compared), 2^20 lanes with 9 Byzantine shares, a count short of the
   rows, an empty batch, counts 1, 37, 255 and 256 x 37 + 1, a
   ``words20[off:]`` view read in place, and two launches right after a
   failed one (cudaErrorInvalidValue, its workspace made dirty first);
   misaligned, non-contiguous and int64 inputs raise before any launch;
15. the scrypt verify path (verify prologue, ROMix B5, verify epilogue)
   against the plain version and hashlib at the ledger's shape (1,024
   lanes, k = 16, 4 planted failures across blocks) and at 256, 37 and 1
   lanes with boundary targets;
16. main path: ``PoolManager.on_share_batch`` with a ``ValidationBackend``
   on the card (min_batch 128, tripwire 5%): 64 flushes of 1,024 sha256d
   shares from 4,096 workers and 4 of 1,024 scrypt shares, from two
   producers at once, about one Byzantine share in 256, and one flush of
   64 under the crossover; every outcome equals hashlib's verdict, the
   books hold exactly the honest shares, the rails stay quiet, B2 ran 64
   times and no plain version ran. Then, outside the counted run, the
   sha256d flushes again without the second producer (per-flush rates,
   median and spread, beside those of the shared run) and an overflowed
   batch settled on the card;
17. B2 ms a call at 128, 1,024, 4,096 and 2^20 lanes beside its bound,
   with the host's enqueue of a call, the kernels a call ran (the
   wrapper's count, and torch.profiler's), and the latency floor under
   any one-launch call (an empty kernel, and B2 on one lane); the scrypt
   verify path at 1,024 and 4,096 lanes beside its bound; where
   ``verify_batch`` on the card overtakes host validation, by batch size
   (the crossover that ``VALIDATE_MIN_BATCH`` sets);
18. engine supervision: a ``MiningEngine`` over two ``CudaBackend``s of
   the one card (``cuda0``, ``cuda1``, each its own stream), one 2^31-nonce
   launch a group, share target 2^228, tight watchdog knobs. An injected 8 s ``device.call`` hang quarantines
   ``cuda1`` within its deadline (health ``degraded``, one active device)
   while ``cuda0`` keeps mining; ``cuda1`` comes back through a B1 probe
   verified against hashlib; the engine's rate with both devices, with
   one and with both again; then a ``corrupt`` window whose probes fail
   the oracle until it closes, and ``stop()`` with a call hung for good
   (bounded by the drain timeout, the call abandoned). Every share is
   re-hashed with hashlib, none twice, the devices' extranonce2 blocks
   disjoint; one probe's launches, its bisect included;
19. a real device-side stall: each call of ``cuda1`` first enqueues a ~4 s
   ``torch.cuda._sleep`` spin on its stream; the watchdog fires, the first
   probe waits behind the spin and the device reintegrates once it has
   drained; ``probe_cuda_devices`` answers for the card meanwhile;
20. warm switching: sha256d -> scrypt -> sha256d -> scrypt -> sha256d
   through ``switch_algorithm``, each backend prepared by
   ``prepare_backend_async`` while the old one mines; each switch's
   downtime, ``memory_allocated`` back within 256 MiB once scrypt's V is
   released, the second round's peak within 256 MiB of the first's, a
   closed backend refuses calls, every share re-hashed with hashlib (and
   hashlib.scrypt); a scrypt probe through B5 on 256 lanes verified
   against hashlib.scrypt;
21. the chain RPC client: ``Application`` in solo mode on the card with
   ``pool.chain_rpc_url`` set to a loopback JSON-RPC node backed by a
   difficulty-1 ``MockChainClient``, until 2 blocks are accepted through
   ``submitblock``, each re-hashed with hashlib; the connection pool's
   keep-alive reuse;
22. pool mode: ``Application`` as ``cli pool --mine`` sets it
   (``stratum.port=0``, ``pool.database=":memory:"``, stratum difficulty
   1, a difficulty-1 mock chain), B1 mining at the engine's defaults
   through the loopback ``StratumClient``; once it mines, 1,000 raw-wire
   miners connect at 500 a second (the per-IP caps lifted in
   ``ServerConfig.ddos``, ``RLIMIT_NOFILE`` raised to its hard limit),
   are retargeted to 1e-7 through the server's retarget path and submit
   3 host-pre-mined shares each over 10 s. Client-seen accepts = the
   ledger hook's deliveries = share rows, per worker; every share
   re-hashed with hashlib; no honest share rejected; a card block on the
   chain and ``distribute_block``'s credits; the share-accept latency of
   the server, the card's client and the fleet; the engine's rate under
   the fleet beside phase 5's;
23. vardiff on the card: a ``StratumServer`` at difficulty 1/64 (~32
   winners a 2^31 launch) with ``VardiffConfig(retarget_seconds=2,
   target_share_seconds=0.5)``, B1 through a ``StratumClient``, a job a
   second for 12 s: overflowed launches bisect and every window's count
   word equals the winners returned; the difficulty climbs at most x4 a
   retarget and each retarget reaches the next job; credits at the
   previous difficulty and low-difficulty rejects counted and explained;
24. upstream failover: the app mining on B1 to the primary of two
   loopback ``StratumServer`` upstreams sharing a session secret; the
   primary stops, ``check_all`` selects the backup and
   ``_connect_upstream`` carries the resume token (the extranonce1 kept);
   the engine's hash count keeps moving; the time from the stop to the
   first accept at the backup;
25. a scrypt pool: phase 22's app with ``mining.algorithm = "scrypt"``
   (the ``romix`` tier, B5) at share difficulty 2^-16 for 10 s: every
   share digested by ``hashlib.scrypt`` on the validation executor and
   re-hashed here; the books equal the client's accepts; the mock
   chain's refusals counted; V's peak memory;
26. ``cli p2p --mine``: an ``Application`` as ``cmd_p2p`` sets it, with
   validation at its defaults on the card, the books in PostgreSQL
   (``tests/pg_emulator.py``'s v3 wire-protocol server on loopback,
   reached by the vendored pgwire driver) and phase 22's stratum and
   mock-chain settings, joins an overlay of 16 of the port's P2P nodes
   (a process of their own, on loopback TCP) holding 10,000 shares at
   difficulty 1e-8; it catches up by locator sync (pages of 200, each a
   B2 call), then verifies 10 s of SHARE_BATCH gossip (500 a second, one
   share in 256 forged) while B1 mines for its stratum pool, then 2 s of
   page-sized batches with the engine stopped. Tips and ``weights()``
   equal everywhere and to ``weights_full()``; every verdict equals
   hashlib's; forged shares never linked nor relayed; B2's launches equal
   the validator's device batches; no verify failure, device error or
   tripwire mismatch; the books exact three ways; B2 held against its plain
   version on a page and a batch; the engine at 97% of phase 5's rate
   or more over the gossip window;
27. a scrypt share chain: phase 26's app with ``mining.algorithm =
   "scrypt"`` and mining off catches up 1,200 scrypt shares from one node
   in 6 pages, each one call of the scrypt verify path around B5; every
   verdict equals hashlib.scrypt's;
28. the durable ``cli p2p --mine`` with the API, SIGKILLed and cold-booted
   (``durable_phase``);
29. x11 known answer: kernel B6's digests of the Dash genesis header and
   three fixed headers (through its verify kernel, each against its
   digest and one below, and its search kernel on the header's own nonce)
   equal the JAX package's chain, written here as constants, and the
   port's host chain (not Dash's network hash: the chain is uncertified);
30. B6 against the plain PyTorch version on the card, buffer for buffer:
   few winners, a target at a lane's digest and +-1, ragged counts (1,
   37, one past a block, one past a chunk of the launch sequence, 2^20 +
   77), a window that wraps 2^32, an empty
   window, table overflow, each of the five shavite counter orders,
   ``X11CudaBackend``'s bisect, the main path's launch; the verify kernel
   on Byzantine rows, an overflow and a count short of the rows;
31. solo x11: ``Application`` with ``mining.algorithm = "x11"`` on the card
   for 20 s against a mock chain whose target gives ~2 shares a second,
   then for 12 s at ~32 a second (a pool's share rate: most groups of
   launches hold winners to re-check): every share re-hashed through the
   host chain, the mock chain's refusals (it checks blocks by sha256d)
   counted, B6 launched and the plain version not, the engine's rate;
32. x11 at the pool ledger: 8 flushes of 1,024 x11 shares (one in ~256
   forged) through ``PoolManager.on_share_batch`` and B6's verify kernel:
   every verdict equals the host chain's, the books hold the honest
   shares, the rails stay quiet, one launch a flush;
33. B6's times (CUDA events, median of rounds) at 2^20, 2^22, the main
   path's launch and 2^24 lanes, each stage's kernel alone over the main
   path's launch, and a 1,024-share verify call, beside the bound (from
   the instructions a lane executes, counted in phase 1 from the SASS of
   B6's counting build, or the one-kernel design's count where that is
   smaller), phase 31's steady rates against B6's (the first window must
   reach 95%), the SM clock and power sampled; a
   sha256d -> x11 -> sha256d warm switch and an x11 probe verified
   against the host chain;
34. ethash epoch 0: the compiled cache generator against the python chain
   at 61 and 1,021 rows, exact; the epoch-0 cache (16,776,896 bytes) in
   seconds; the DAG (1,073,739,904 bytes) by B7a, its time beside its
   bound, all of it against the plain ``build_dataset`` and 8 items
   against ``calc_dataset_item``; the L2 probe's rate for random 64-byte
   rows (``ethash.cu`` ``l2_probe_kernel``, its size raised until the rate
   stops rising, or said to be a lower estimate) and B7a's cache-row bytes
   (~275 GB) as a rate and a share of it;
35. B7b against the plain version, buffer for buffer: the full tier at
   2^20 lanes and the light tier at 2^12, each with one winner, an
   overflow at k = 16, a count ending mid-block and a window past 2^32;
   the light tier at counts 0, 1 and 37; both at the engine's launches
   and the light tier at 2^14 with ~8 winners; B7c at counts 0, 1, 3,
   129, 1,023 and 1,024 (nonces over the 64 bits, one share in ~9
   forged, every row past the count forged) at k = 16 and k = 256; 16
   dense results equal across the light and full plain versions and the
   host oracle (``hashimoto_light_batch``);
36. B7b full at 2^22 lanes, the engine's launch and 2^24, light at 2^14
   and the engine's 2^18 (with its cache-row bytes as a rate and a share
   of the probe's), and a 1,024-share B7c call, each beside its bound
   (operations counted from the SASS of B7's counting build; bytes), the
   SM clock and power sampled; B7c on one share, and its floor: a
   share's 16,384 dependent cache-row reads timed by the chase probe
   (``ethash.cu`` ``chase_probe_kernel``);
37. solo ethash: ``Application`` with ``mining.algorithm = "ethash"`` on
   the card at epoch 0 (the light tier at once, the full tier when its
   DAG lands: the time to it), 20 s on the full tier (its steady rate
   >= 95% of B7b full's at the engine's launch), then jobs at blocks
   29,990 (epoch 1 prefetched), 30,005 (mined) and 60,005 (not
   prefetched: light, then full, epoch 0's DAG evicted): the times to
   each epoch's first share and full tier, ``build_failures`` 0, at
   most ``ETHASH_MAX_FULL_TIERS`` DAGs resident, the memory back after the
   eviction and after the stop; epoch 2's switch broken down from the
   template's move (``EpochSwitchClock``: the job at the backend, the
   cache, B7a's launch and run, each light call's run on the card, the
   first full-tier group, the first share); every share through the host oracle,
   the mock chain's refusals counted, B7a-B7b launched and the plain
   version not;
38. ethash at the pool ledger: 8 flushes of 1,024 epoch-0 shares (one in
   ~256 forged) through ``PoolManager.on_share_batch`` and B7c, every
   verdict the host oracle's (computed on spawned processes), the books,
   the rails, one launch a flush; then 2 rounds of the 8 as concurrent
   dispatches on one validator.

The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints neither.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import gc
import hashlib
import json
import logging
import os
import struct
import subprocess
import sys
import threading
import time
import traceback

T0 = time.monotonic()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 20261016
MAIN_BATCH = 1 << 31          # the engine's launch: CudaBackend.preferred_batch
GENESIS_HASH = "000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f"
BLOCKS_NEEDED = 3
MAIN_PATH_MIN_S = 5.0         # the solo sha256d window: 3 blocks and this long
MAIN_PATH_BOUND_S = 180.0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
# 32-bit integer instructions an SM can issue per clock, thread by thread:
# four schedulers, one 32-thread warp instruction each. Integer work goes
# to the ALU pipe (IADD3, LOP3, SHF: 64 threads a clock) and to the FMA
# pipe (IMAD and its IADD/MOV/SHL forms: 64 more), so no mix of integer
# instructions issues faster. The bounds below take this ceiling.
INT32_LANES_PER_SM = 128
# phase 17 profiles a B2 call again when torch.profiler saw fewer of its
# kernels than were launched (it loses records on some hosts)
PROFILE_ATTEMPTS = 6
SCRYPT_NBITS = 0x1F00FFFF     # about one scrypt share per 2^16 hashes
SCRYPT_WINDOW_S = 20.0        # the scrypt main path's fixed window


# work behind the phases: B6's counting build (``x11_cuda.chain_instructions``)
BACKGROUND = concurrent.futures.ThreadPoolExecutor(1)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase(name: str) -> None:
    """A phase's header, with the seconds since the script started (the
    whole run must end within 1,200 s, builds included)."""
    print(f"== {name}  [at {time.monotonic() - T0:.1f} s]", flush=True)


def median_ms(fn, stream, reps: int, rounds: int = 3):
    """Median over ``rounds`` of the mean time of ``reps`` calls of ``fn``
    (which launches on ``stream``), by CUDA events, after one warm-up
    call. Returns (median, the rounds)."""
    import torch

    with torch.cuda.stream(stream):
        fn()
        round_ms = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(reps):
                fn()
            stop.record(stream)
            stop.synchronize()
            round_ms.append(start.elapsed_time(stop) / reps)
    return sorted(round_ms)[rounds // 2], round_ms


class ErrorCount(logging.Handler):
    """Counts the ERROR records of a logger (a device winner that fails the
    backend's host re-check is logged as one)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.n = 0

    def emit(self, record):
        self.n += 1


class HashWatch:
    """The instants at which the engine's hash count moves (it moves once
    a drained device call, by that call's hashes) and at which its job
    changes, polled every 2 ms on the engine's own loop. Between the
    first and the last move the rate is the engine's steady rate: no
    start-up, and no call half done at either end."""

    def __init__(self):
        self.engine, self.moves, self.switches, self._task = None, [], [], None

    async def _poll(self):
        last, serial = self.engine.stats.hashes, self.engine._job_serial
        while True:
            h, now = self.engine.stats.hashes, time.monotonic()
            if self.engine._job_serial != serial:
                serial = self.engine._job_serial
                self.switches.append(now)
            if h != last:
                self.moves.append((now, h))
                last = h
            await asyncio.sleep(0.002)

    def start(self, engine):
        self.engine = engine
        self._task = asyncio.get_running_loop().create_task(self._poll())

    def stop(self):
        self._task.cancel()

    def between(self, t0: float, t1: float) -> tuple[float, str]:
        """(H/s, its description) between the first and the last drained
        call in [t0, t1]."""
        inside = [(t, h) for t, h in self.moves if t0 <= t <= t1]
        check(len(inside) >= 3, "the engine's hash count barely moved "
              f"between {t0:.1f} and {t1:.1f}")
        (ta, ha), (tb, hb) = inside[0], inside[-1]
        gaps = sorted(b[0] - a[0] for a, b in zip(inside, inside[1:]))
        rate = (hb - ha) / (tb - ta)
        return rate, (f"{rate / 1e9:.3f} GH/s: {hb - ha} hashes in "
                      f"{tb - ta:.3f} s between the first and the last of "
                      f"{len(inside)} drained calls; gaps median "
                      f"{gaps[len(gaps) // 2] * 1e3:.1f} ms, max "
                      f"{gaps[-1] * 1e3:.1f} ms")

    def summary(self) -> tuple[float, str]:
        """(steady H/s, its description): the rate, the gaps between
        drained calls, and for a short window each gap (* where the job
        changed within it)"""
        check(len(self.moves) >= 3, "the engine's hash count barely moved")
        (t0, h0), (t1, h1) = self.moves[0], self.moves[-1]
        rate = (h1 - h0) / (t1 - t0)
        spans = list(zip(self.moves, self.moves[1:]))
        gaps = sorted(b - a for (a, _), (b, _) in spans)
        listed = ""
        if len(spans) <= 24:
            listed = "; gaps " + ", ".join(
                f"{(b - a) * 1e3:.1f}"
                + ("*" if any(a < t <= b for t in self.switches) else "")
                for (a, _), (b, _) in spans)
        return rate, (f"steady {rate:.1f} H/s: {h1 - h0} hashes in "
                      f"{t1 - t0:.3f} s between the first and the last of "
                      f"{len(self.moves)} drained calls; gaps median "
                      f"{gaps[len(gaps) // 2] * 1e3:.1f} ms, max "
                      f"{gaps[-1] * 1e3:.1f} ms{listed}")


def scrypt_value(header80: bytes) -> int:
    """hashlib's scrypt of a header, as the little-endian integer."""
    return int.from_bytes(hashlib.scrypt(header80, salt=header80, n=1024, r=1,
                                         p=1, dklen=32), "little")


def scrypt_main_path(chain_nbits: int, window_s: float):
    """Phase 10: solo scrypt ``Application`` on the card for ``window_s``
    seconds once the engine runs. Returns what the checks need."""
    import torch

    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig
    from otedama_tpu_torch.pool.blockchain import MockChainClient

    cfg = AppConfig()
    cfg.mining.algorithm = "scrypt"
    cfg.mining.device = "cuda"
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.5
    chain = MockChainClient(nbits=chain_nbits)
    app = Application(cfg, chain=chain)
    shares, outcomes = [], []
    on_share, submit = app._on_share, chain.submit_block

    async def record_share(share):
        shares.append((share, app.worksource.get_job(share.job_id)))
        await on_share(share)

    async def record_submit(header):
        outcome = await submit(header)
        outcomes.append(outcome)
        return outcome

    app._on_share = record_share
    chain.submit_block = record_submit

    async def run():
        await app.start()
        try:
            t_end = time.monotonic() + MAIN_PATH_BOUND_S
            while app.engine.state.value != "running":
                check(time.monotonic() < t_end, "scrypt engine never started")
                check(not any(t.done() and not t.cancelled() and t.exception()
                              for t in app._tasks),
                      "a background task failed before the engine started")
                await asyncio.sleep(0.05)
            watch.start(app.engine)
            h0, t0 = app.engine.stats.hashes, time.monotonic()
            with Sampler(1.0) as sampled:
                await asyncio.sleep(window_s)
            h1, t1 = app.engine.stats.hashes, time.monotonic()
            watch.stop()
            return h1 - h0, t1 - t0, sampled.summary()
        finally:
            await app.stop()

    from otedama_tpu_torch.kernels.card import Sampler

    torch.cuda.reset_peak_memory_stats()
    watch = HashWatch()
    hashes, seconds, clocks = asyncio.run(run())
    peak = torch.cuda.max_memory_allocated()
    backend = next(iter(app.engine.backends.values()))
    result = dict(hashes=hashes, seconds=seconds, shares=shares,
                  steady=watch.summary(), clocks=clocks,
                  outcomes=outcomes, total_hashes=app.engine.stats.hashes,
                  backend=backend.name, chunk=backend.chunk,
                  batch=app.engine.planned_batch(backend),
                  depth=app.engine.config.pipeline_depth, peak=peak)
    del app, backend
    torch.cuda.empty_cache()
    return result


def scrypt_phases(dev, card: str, int_ops_per_s: float) -> list[dict]:
    """Phases 6-12 (scrypt); returns the kernels' records for B3-B5."""
    import numpy as np
    import torch

    from otedama_tpu_torch.engine.jobs import header_from_share
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import scrypt_torch as sct
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.kernels.card import Sampler
    from otedama_tpu_torch.runtime.search import (
        SCRYPT_CUDA_CHUNK,
        JobConstants,
        ScryptCudaBackend,
    )

    chunk = SCRYPT_CUDA_CHUNK
    k = 16
    full = 0xFFFFFFFF
    rng = np.random.default_rng(SEED + 1)
    max_err = {"B3": 0, "B4": 0, "B5": 0}
    plain_ms = {}

    def words(*shape):
        w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    def err(a, b):
        """max |a - b| over the uint32 values of two int32 tensors"""
        return int(((a.long() & full) - (b.long() & full)).abs().max().item())

    def host(t):
        return t.cpu().numpy().view(np.uint32)

    def sync():
        torch.cuda.synchronize(dev)

    # -- 6. known answer --------------------------------------------------------
    phase("6 scrypt known answer: hashlib.scrypt")
    h76 = bytes(rng.integers(0, 256, 76, dtype=np.uint8))
    h19 = sct.header_words19(h76)
    nonces = [0, 1, 0x7FFFFFFF, full]
    d = sct.scrypt_1024_1_1(h19, torch.tensor(nonces, device=dev),
                            romix_fn=lambda Xt: scc.romix(Xt))
    got = torch.stack(d).T.cpu().numpy().astype(">u4")
    for lane, nw in enumerate(nonces):
        header80 = h76 + struct.pack(">I", nw)
        want = hashlib.scrypt(header80, salt=header80, n=1024, r=1, p=1, dklen=32)
        check(got[lane].tobytes() == want,
              f"scrypt digest of nonce {nw:#x}: {got[lane].tobytes().hex()} "
              f"!= hashlib {want.hex()}")
    print(f"   ROMix kernel in the pipeline: {len(nonces)} digests equal "
          "hashlib.scrypt", flush=True)
    base, span = full - 31, 64                  # the window wraps 2^32
    vals = {(base + i) & full: scrypt_value(h76 + struct.pack(">I", (base + i) & full))
            for i in range(span)}
    target = sorted(vals.values())[2]
    expect = sorted(vals, key=lambda nw: (nw - base) & full)
    expect = [nw for nw in expect if vals[nw] <= target]
    limbs = tgt.target_to_limbs(target)
    for tier in scc.TIERS:
        b = host(scc.scrypt_search(h19, base, limbs, span - 1, n=span, k=k,
                                   device=dev, tier=tier))
        check(int(b[2 * k]) == 3 and b[:3].tolist() == expect
              and b[k:k + 3].tolist() == [vals[nw] >> 224 for nw in expect]
              and int(b[2 * k + 2]) == min(vals.values()) >> 224,
              f"search kernels ({tier}) vs hashlib: {b.tolist()}")
    print(f"   search kernels, every tier: the 3 winners of {span} lanes "
          "across 2^32 equal hashlib's", flush=True)

    # -- 7. B3, B4 -----------------------------------------------------------
    phase(f"7 scrypt BlockMix kernels B3, B4 vs plain version, [32, {chunk}]")
    X, V = words(32, chunk), words(32, chunk)
    for name, v in (("B3", None), ("B4", V)):
        a = scc.blockmix(X, v)
        sct.blockmix(X, v)      # warm-up: the first call pays set-up
        sync()
        t0 = time.monotonic()
        b = sct.blockmix(X, v)
        sync()
        plain_ms[name] = (time.monotonic() - t0) * 1e3
        max_err[name] = err(a, b)
        check(max_err[name] == 0, f"{name}: kernel != plain version")
        print(f"   {name}: equal; plain version {plain_ms[name]:.1f} ms", flush=True)

    # -- 8. B5 -------------------------------------------------------------------
    phase(f"8 scrypt ROMix kernel B5 vs plain version, [32, {chunk}]")
    X = words(32, chunk)
    ragged = chunk - 5      # lanes are independent: the plain version's
    for half in (False, True):  # first `ragged` lanes hold that launch too
        a = scc.romix(X, half_v=half)
        r = scc.romix(X[:, :ragged].contiguous(), half_v=half)
        sync()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        b = sct.romix(X, half_v=half)
        sync()
        t = (time.monotonic() - t0) * 1e3
        if not half:
            plain_ms["B5"] = t
        e = max(err(a, b), err(r, b[:, :ragged]))
        for lanes in (1, 37, 4099):     # not multiples of a quad, warp or block
            e = max(e, err(scc.romix(X[:, :lanes].contiguous(), half_v=half),
                           sct.romix(X[:, :lanes].contiguous(), half_v=half)))
        max_err["B5"] = max(max_err["B5"], e)
        check(e == 0, f"B5 half_v={half}: kernel != plain version")
        print(f"   half_v={half}: equal at {chunk}, {ragged}, 4099, 37 and 1 "
              f"lanes; plain version {t / 1e3:.1f} s at {chunk}", flush=True)
        del a, b, r
        torch.cuda.empty_cache()

    # -- 9. search buffers ------------------------------------------------------------
    phase("9 scrypt search kernels vs plain version")

    def compare(name, base, top, last, n):
        h = sct.header_words19(bytes(rng.integers(0, 256, 76, dtype=np.uint8)))
        lb = np.asarray([top] + [full] * 7, dtype=np.uint32)
        a = host(scc.scrypt_search(h, base, lb, last, n=n, k=k, device=dev))
        b = host(sct.scrypt_search_buffer(h, base, lb, last, n=n, k=k,
                                          device=dev))
        nb = int(b[2 * k])
        words_ = slice(None) if nb <= k else slice(2 * k, None)
        check(np.array_equal(a[words_], b[words_]),
              f"{name}: kernel {a.tolist()} != plain {b.tolist()}")
        print(f"   {name}: n={nb}, min_h0={b[2 * k + 2]:#010x} equal", flush=True)
        return nb

    # top limb 2^32 * 2 / chunk: about two winners in the chunk
    check(compare(f"{chunk} lanes, few winners", int(rng.integers(1 << 32)),
                  (1 << 33) // chunk, chunk - 1, chunk) <= k,
          "few-winner case overflowed")
    check(compare("4096 lanes, n > k", 77, 1 << 26, 4095, 4096) > k,
          "overflow case did not overflow")
    compare("last mid-chunk, base near 2^32", full - 1500, 1 << 24, 2999, 4096)
    lanes = 64      # a scratch off the card is refused before any launch
    launches = scc.search_launches.value
    try:
        scc.scrypt_search(h19, 0, [full] * 8, lanes - 1, n=lanes,
                          k=k, device=dev, scratch=(
                              torch.empty(32 * lanes, dtype=torch.int32),
                              torch.empty(scc.scratch_words(lanes),
                                          dtype=torch.int32, device=dev)))
        refused = False
    except ValueError:
        refused = True
    check(refused and scc.search_launches.value == launches,
          "an x scratch on the CPU was not refused")
    print("   an x scratch on the CPU is refused with ValueError", flush=True)

    # -- 10. main path --------------------------------------------------------------
    phase("10 scrypt main path: solo Application on the card, nbits 0x1f00ffff")
    for counter in (scc.romix_launches, scc.search_launches,
                    scc.blockmix_launches, scc.blockmix_xor_launches, sct.calls):
        counter.reset()
    # every share is a block candidate that the mock chain refuses: keep
    # its one warning per refusal out of the log (they are counted below)
    logging.getLogger("otedama.app").setLevel(logging.ERROR)
    recheck_failures = ErrorCount()
    logging.getLogger("otedama.runtime.search").addHandler(recheck_failures)
    main = scrypt_main_path(SCRYPT_NBITS, SCRYPT_WINDOW_S)
    logging.getLogger("otedama.runtime.search").removeHandler(recheck_failures)
    logging.getLogger("otedama.app").setLevel(logging.NOTSET)
    check(recheck_failures.n == 0, f"{recheck_failures.n} device winners "
          "failed the backend's host re-check")
    romix_main = scc.romix_launches.value
    search_main = scc.search_launches.value
    plain_main = sct.calls.value
    check(romix_main > 0 and search_main > 0, "scrypt main path launched no kernel")
    check(plain_main == 0, f"scrypt main path called the plain version "
          f"{plain_main} times")
    check(scc.blockmix_launches.value == scc.blockmix_xor_launches.value == 0,
          "the romix tier launched BlockMix kernels")
    check(main["shares"], "scrypt main path found no share")
    total = torch.cuda.get_device_properties(dev).total_memory
    check(main["peak"] < total, "scrypt main path outgrew the card's memory")
    for share, job in main["shares"]:
        check(job is not None, f"share of an unknown job {share.job_id}")
        header = header_from_share(job, share.extranonce2, share.ntime,
                                   share.nonce_word)
        value = scrypt_value(header)
        check(value.to_bytes(32, "little") == share.digest
              and value <= job.share_target,
              f"share {share.nonce_hex} fails the hashlib.scrypt re-check")
    accepted = sum(o.accepted for o in main["outcomes"])
    refused = {}
    for o in main["outcomes"]:
        if not o.accepted:
            refused[o.reason] = refused.get(o.reason, 0) + 1
    e2e = main["hashes"] / main["seconds"]
    print(f"   backend {main['backend']}, chunk {main['chunk']}, batch "
          f"{main['batch']}: {main['hashes']} hashes in {main['seconds']:.2f} s"
          f" = {e2e:.1f} H/s end to end; {main['steady'][1]}; "
          f"{main['clocks']}; {len(main['shares'])} shares, all "
          f"re-hashed with hashlib.scrypt; block candidates submitted "
          f"{len(main['outcomes'])}: accepted {accepted}, refused {refused} "
          f"(the mock chain checks blocks by sha256d); host re-check "
          f"failures {recheck_failures.n}; romix launches "
          f"{romix_main}, search launches {search_main}, plain-version calls "
          f"{plain_main}; peak device memory {main['peak'] / 2**30:.2f} GiB "
          f"of {total / 2**30:.2f} at pipeline depth {main['depth']}",
          flush=True)

    # -- 11. the blockmix tier ----------------------------------------------------
    phase("11 scrypt blockmix tier (B3, B4) vs romix tier, one chunk")
    jc = JobConstants.from_header_prefix(
        bytes(rng.integers(0, 256, 76, dtype=np.uint8)),
        tgt.limbs_to_target([(1 << 34) // chunk] + [full] * 7))  # ~4 a chunk
    base = int(rng.integers(1 << 32))
    romix_tier = ScryptCudaBackend(dev)
    want = romix_tier.search(jc, base, chunk)
    # three searches in flight on one backend, as the engine keeps them:
    # they share its V scratch and must give what they give one by one
    windows = [((base + i * chunk) & full, chunk) for i in range(3)]
    alone = [romix_tier.search(jc, b, c) for b, c in windows]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        together = list(pool.map(lambda w: romix_tier.search(jc, *w), windows))
    for a, b in zip(alone, together):
        check([w.nonce_word for w in a.winners] == [w.nonce_word for w in b.winners]
              and a.best_hash_hi == b.best_hash_hi,
              "concurrent searches on one backend differ from sequential ones")
    print(f"   3 concurrent searches on one romix-tier backend equal 3 "
          f"sequential ones ({sum(len(a.winners) for a in alone)} winners)",
          flush=True)
    del romix_tier
    torch.cuda.empty_cache()
    from otedama_tpu_torch.engine.algo_manager import AlgorithmManager

    bm_backend = AlgorithmManager("auto").backend_for("scrypt", tier="blockmix")
    scc.blockmix_launches.reset()
    scc.blockmix_xor_launches.reset()
    got = bm_backend.search(jc, base, chunk)
    bm_launches = (scc.blockmix_launches.value, scc.blockmix_xor_launches.value)
    check([(w.nonce_word, w.digest) for w in got.winners]
          == [(w.nonce_word, w.digest) for w in want.winners]
          and got.best_hash_hi == want.best_hash_hi,
          f"blockmix tier winners {[w.nonce_hex for w in got.winners]} != "
          f"romix tier {[w.nonce_hex for w in want.winners]}")
    check(all(bm_launches), "the blockmix tier launched no BlockMix kernel")
    print(f"   {bm_backend.name}: {len(got.winners)} winners equal the romix "
          f"tier's; B3 launches {bm_launches[0]}, B4 launches {bm_launches[1]}",
          flush=True)
    del bm_backend
    torch.cuda.empty_cache()

    # -- 12. times ---------------------------------------------------------------------
    phase(f"12 scrypt times per chunk of {chunk} lanes")
    stream = torch.cuda.Stream(dev)
    X, V, Y = words(32, chunk), words(32, chunk), words(32, chunk)
    ms = {}
    ms["B3"], _ = median_ms(lambda: scc.blockmix(X, out=Y, stream=stream),
                            stream, 20)
    ms["B4"], _ = median_ms(lambda: scc.blockmix(X, V, out=Y, stream=stream),
                            stream, 20)
    scratch = torch.empty(scc.scratch_words(chunk), dtype=torch.int32, device=dev)
    ms["B5"], rounds_b5 = median_ms(
        lambda: scc.romix(X, scratch=scratch, stream=stream), stream, 3)
    xs = torch.empty(32 * chunk, dtype=torch.int32, device=dev)
    out = torch.empty(2 * k + 3, dtype=torch.int32, device=dev)
    lb = tgt.target_to_limbs(tgt.bits_to_target(SCRYPT_NBITS))
    tier_ms = {}
    for tier in scc.TIERS:
        with Sampler() as sampled:
            tier_ms[tier], rounds = median_ms(
                lambda: scc.scrypt_search(h19, 0, lb, chunk - 1, n=chunk, k=k,
                                          device=dev, tier=tier, stream=stream,
                                          out=out, scratch=(xs, scratch)),
                stream, 2)
        half = tier == "romix-half"
        ops_ms = scc.ops_per_hash(half) * chunk / int_ops_per_s * 1e3
        bytes_ms = scc.v_bytes_per_hash(half) * chunk / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        print(f"   search, {tier}: {tier_ms[tier]:.2f} ms per chunk = "
              f"{chunk / tier_ms[tier] * 1e3:.0f} H/s (rounds "
              + ", ".join(f"{t:.2f}" for t in rounds)
              + f"); bound {bound:.2f} ms = {chunk / bound * 1e3:.0f} H/s, "
              f"by {'operations' if ops_ms >= bytes_ms else 'bytes'} "
              f"(operations {ops_ms:.2f} ms: {scc.ops_per_hash(half):.0f} "
              f"int32 ops/hash"
              + (", half of the mix steps recomputing a row" if half else "")
              + f"; bytes {bytes_ms:.2f} ms: {scc.v_bytes_per_hash(half)} B "
              f"of V/hash); {sampled.summary()}", flush=True)
    # the romix tier sustained as the main path runs it, chunks back to
    # back for ~5 s: under that load the card may hold a lower clock (its
    # power limit) than in the short rounds above
    with Sampler(0.5) as sampled:
        sustained, _ = median_ms(
            lambda: scc.scrypt_search(h19, 0, lb, chunk - 1, n=chunk, k=k,
                                      device=dev, stream=stream, out=out,
                                      scratch=(xs, scratch)), stream, 180, 1)
    steady, window = main["steady"][0], main["hashes"] / main["seconds"]
    rounds_rate = chunk / tier_ms["romix"] * 1e3
    print(f"   search, romix, 180 chunks back to back: {sustained:.2f} ms per "
          f"chunk = {chunk / sustained * 1e3:.0f} H/s; {sampled.summary()}; "
          f"the main path's rate (phase 10) from the engine's start is "
          f"{window / rounds_rate:.1%} of the rounds' rate and "
          f"{window / (chunk / sustained * 1e3):.1%} of this one, its steady "
          f"rate {steady / rounds_rate:.1%} and "
          f"{steady / (chunk / sustained * 1e3):.1%}", flush=True)
    for lanes in (1 << 16, 1 << 17, 1 << 18):   # the chunk sweep
        t, _ = median_ms(
            lambda: scc.scrypt_search(h19, 0, lb, lanes - 1, n=lanes, k=k,
                                      device=dev, stream=stream, out=out,
                                      scratch=(xs, scratch)), stream, 2)
        print(f"   search, romix, chunk 2^{lanes.bit_length() - 1}: {t:.2f} ms"
              f" = {lanes / t * 1e3:.0f} H/s", flush=True)
    del scratch, xs
    torch.cuda.empty_cache()

    row = scc.ROW_WORDS * 4
    # (int32 ops, bytes) of one launch at [32, chunk]: X in and out, and
    # for B5 V's rows written and read in device memory, as V (32 GiB at
    # 2^18 lanes) cannot stay on the chip
    work = {
        "B3": (scc.BLOCKMIX_OPS * chunk, 2 * row * chunk),
        "B4": ((scc.ROW_WORDS + scc.BLOCKMIX_OPS) * chunk, 3 * row * chunk),
        "B5": (scc.romix_ops() * chunk,
               (2 * row + scc.v_bytes_per_hash()) * chunk),
    }
    launches = {"B3": bm_launches[0], "B4": bm_launches[1], "B5": romix_main}
    meta = {
        "B3": ("scrypt_blockmix", "otedama_tpu/kernels/scrypt_pallas.py:89",
               "ScryptCudaBackend(tier='blockmix'), one chunk (phase 11)"),
        "B4": ("scrypt_blockmix_xor", "otedama_tpu/kernels/scrypt_pallas.py:95",
               "ScryptCudaBackend(tier='blockmix'), one chunk (phase 11)"),
        "B5": ("scrypt_romix", "otedama_tpu/kernels/scrypt_pallas.py:176",
               "solo scrypt Application (phase 10)"),
    }
    records = []
    for key, (ops, nbytes) in work.items():
        ops_ms = ops / int_ops_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        name, replaces, path = meta[key]
        print(f"   {key} {name}: {ms[key]:.3f} ms per launch, bound "
              f"{max(ops_ms, bytes_ms):.3f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}), plain "
              f"version {plain_ms[key]:.1f} ms; {card}", flush=True)
        records.append({
            "name": name,
            "route": "cuda",
            "source": "otedama_tpu_torch/kernels/csrc/scrypt.cu",
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max_err[key],
            "ms": ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "path": path,
        })
    print(f"   B5 rounds, ms per launch: "
          + ", ".join(f"{t:.2f}" for t in rounds_b5), flush=True)
    return records


def limbs_of_digests(digests: bytes):
    """Compare-order limbs (most-significant-first) of concatenated 32-byte
    digests read as little-endian integers: ``uint32[N, 8]``."""
    import numpy as np

    return np.frombuffer(digests, dtype="<u4").reshape(-1, 8)[:, ::-1].copy()


def limbs_step(limbs, delta: int):
    """``limbs`` (uint32 ``[N, 8]``, most-significant-first) plus ``delta``
    (+1 or -1) per row, with carry; rows must not wrap 2^256."""
    import numpy as np

    out = limbs.astype(np.int64)
    carry = np.full(len(out), delta, dtype=np.int64)
    for j in range(7, -1, -1):
        out[:, j] += carry
        carry = np.where(out[:, j] < 0, -1, np.where(out[:, j] > 0xFFFFFFFF, 1, 0))
        out[:, j] &= 0xFFFFFFFF
    return out.astype(np.uint32)


def sha256d_values(headers) -> bytes:
    """hashlib sha256d of every row of ``headers`` (uint8 ``[N, 80]``),
    concatenated."""
    return b"".join(hashlib.sha256(hashlib.sha256(h.tobytes()).digest()).digest()
                    for h in headers)


def scrypt_values(headers) -> bytes:
    """hashlib scrypt of every row of ``headers`` (uint8 ``[N, 80]``) on 8
    threads (hashlib.scrypt releases the interpreter lock)."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return b"".join(pool.map(
            lambda h: hashlib.scrypt(h, salt=h, n=1024, r=1, p=1, dklen=32),
            [h.tobytes() for h in headers]))


def validation_phases(dev, card: str, int_ops_per_s: float):
    """Phases 13-17 (share validation at the pool ledger). Returns B2's
    record, the ROMix launches of the ledger's scrypt flushes, and the
    scrypt verify path's max_abs_err against its plain version."""
    import numpy as np
    import torch

    from otedama_tpu_torch.db import connect_database
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import scrypt_torch as sct
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.pool.manager import PoolManager
    from otedama_tpu_torch.runtime.validate import ShareCheck, ValidationBackend
    from otedama_tpu_torch.stratum.server import AcceptedShare

    rng = np.random.default_rng(SEED + 2)
    full = 0xFFFFFFFF
    max_err = {"B2": 0, "scrypt": 0}

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    def host(t):
        torch.cuda.synchronize(dev)
        return t.cpu().numpy().view(np.uint32)

    def failures(buf, k):
        """(offsets, limbs, count, min) of a read-back failure buffer"""
        n = int(buf[2 * k])
        m = min(n, k)
        return buf[:m].tolist(), buf[k:k + m].tolist(), n, int(buf[2 * k + 2])

    def versus_plain(name, words, limbs, count, k, scrypt=False, tensors=None):
        """kernel vs plain version on the card, on the same inputs (arrays,
        or ``tensors`` on the card as they are): every word when n <= k,
        else the count and the min"""
        w, t = tensors or (on_card(words), on_card(limbs))
        kernel, plain = ((scc.scrypt_verify, sct.scrypt_verify_step) if scrypt
                         else (sc.sha256d_verify, st.sha256d_verify_step))
        a = host(kernel(w, t, count, k=k))
        b = host(plain(w, t, count - 1, k=k))
        n = int(b[2 * k])
        sel = slice(None) if n <= k else np.r_[2 * k, 2 * k + 2]
        diff = np.abs(a[sel].astype(np.int64) - b[sel].astype(np.int64))
        check(not diff.any(), f"{name}: kernel {a.tolist()[:40]} != plain "
              f"{b.tolist()[:40]}")
        max_err["scrypt" if scrypt else "B2"] = max(
            max_err["scrypt" if scrypt else "B2"], int(diff.max()))
        print(f"   {name}: {count} of {len(w)} rows, k={k}, n={n}"
              f"{' (overflow: count and min)' if n > k else ''}, "
              f"min_h0={b[2 * k + 2]:#010x} equal", flush=True)
        return a

    def boundary(limbs, pattern):
        """targets from digest limbs: pattern[i] in (0, -1, +1) per row"""
        out = limbs.copy()
        for delta in (-1, 1):
            rows = pattern == delta
            out[rows] = limbs_step(limbs[rows], delta)
        return out

    # -- 13. known answer ------------------------------------------------------
    phase("13 B2 known answer: genesis block, boundary targets vs hashlib")
    merkle = bytes.fromhex(
        "4a5e1e4baab89f3a32518a88c31bc87f618f76673e2cc77ab2127b7afdeda33b")[::-1]
    genesis = (struct.pack("<I", 1) + bytes(32) + merkle
               + struct.pack("<III", 1231006505, 0x1D00FFFF, 2083236893))
    gv = int.from_bytes(hashlib.sha256(hashlib.sha256(genesis).digest()).digest(),
                        "little")
    check(gv.to_bytes(32, "little")[::-1].hex() == GENESIS_HASH, "genesis digest")
    words = st.headers_to_words([genesis] * 3)
    limbs = np.stack([tgt.target_to_limbs(t) for t in
                      (tgt.bits_to_target(0x1D00FFFF), gv, gv - 1)])
    offs, fl, n, mn = failures(host(sc.sha256d_verify(on_card(words),
                                                      on_card(limbs), 3)), 16)
    check((offs, fl, n, mn) == ([2], [gv >> 224], 1, gv >> 224),
          f"genesis: failures {offs} {fl} n={n} min={mn:#x}")
    print("   genesis passes at bits 0x1d00ffff and at its digest, fails at "
          "digest - 1", flush=True)
    headers = rng.integers(0, 256, (37, 80), dtype=np.uint8)
    hl = limbs_of_digests(sha256d_values(headers))
    pattern = np.array([0, -1, 1])[np.arange(37) % 3]
    offs, _, n, mn = failures(host(sc.sha256d_verify(
        on_card(st.headers_to_words(headers)), on_card(boundary(hl, pattern)),
        37)), 16)
    check(offs == list(range(1, 37, 3)) and n == 12 and mn == int(hl[:, 0].min()),
          f"boundary batch: failures {offs}, n={n}")
    print(f"   37 headers at v, v-1, v+1: failures {offs} = hashlib's", flush=True)

    # -- 14. B2 against its plain version --------------------------------------
    phase("14 B2 vs plain version on the card")
    for lanes, k in ((1024, 512), (1 << 20, 16)):
        headers = rng.integers(0, 256, (lanes, 80), dtype=np.uint8)
        hl = limbs_of_digests(sha256d_values(headers))
        words = st.headers_to_words(headers)
        third = np.array([0, -1, 1])[rng.integers(0, 3, lanes)]
        a = versus_plain(f"{lanes} lanes, one Byzantine in three", words,
                         boundary(hl, third), lanes, k)
        want = np.nonzero(third == -1)[0]
        check(int(a[2 * k]) == len(want), "failure count != Byzantine count")
        if len(want) <= k:
            check(a[:len(want)].tolist() == want.tolist(),
                  "failing offsets != the Byzantine rows")
        if lanes == 1 << 20:
            few = np.zeros(lanes, dtype=np.int64)
            few[rng.choice(lanes, 9, replace=False)] = -1
            a = versus_plain(f"{lanes} lanes, 9 Byzantine", words,
                             boundary(hl, few), lanes, k)
            check(a[:9].tolist() == np.nonzero(few)[0].tolist(),
                  "2^20 lanes: failing offsets != the Byzantine rows")
    zeros = np.zeros((1024, 8), dtype=np.uint32)  # zero targets: all fail
    versus_plain("count stops short (rows past it would all fail)", words[:1024],
                 np.concatenate([hl[:700], zeros[700:]]), 700, 16)
    a = versus_plain("empty batch", words[:64], zeros[:64], 0, 16)
    check(int(a[32]) == 0 and int(a[34]) == full, "empty batch buffer")
    # the counts around a block's rows (128 or 256 a block by the lane
    # count), a few Byzantine shares each and all-failing rows past count
    for count in (1, 37, 255, 256 * 37 + 1):
        sel = hl[:count + 3].copy()
        sel[count:] = 0
        byz = rng.choice(count, min(count, 5), replace=False)
        sel[byz] = limbs_step(hl[byz], -1)
        a = versus_plain(f"count {count}", words[:count + 3], sel, count, 16)
        check(a[:len(byz)].tolist() == sorted(byz.tolist()),
              f"count {count}: failing offsets != the Byzantine rows")
    # a words20[off:] view: 16-byte aligned rows, read in place
    off, count = 3, 300
    few = hl[:off + count].copy()
    few[off + rng.choice(count, 4, replace=False)] = 0
    w_all, t_all = on_card(words[:off + count]), on_card(few)
    versus_plain("words20[3:] view", None, None, count, 16,
                 tensors=(w_all[off:], t_all[off:]))
    # a launch after a failed one: the wrapper's call fails (k = 0 through
    # the C entry point: cudaErrorInvalidValue) with its stream's
    # workspace made dirty first; the wrapper zeroes it and raises, and
    # the launches after it are exact
    lib = sc.load_library()
    real = lib.otedama_sha256d_verify

    def fails_dirty(w, t, lanes, k, out, ws, stream):
        sc._workspaces[stream].fill_(7)
        return real(w, t, lanes, 0, out, ws, stream)

    lib.otedama_sha256d_verify = fails_dirty
    before = sc.verify_launches.value
    try:
        sc.sha256d_verify(w_all, t_all, count, k=16)
        failed = None
    except RuntimeError as exc:
        failed = str(exc)
    finally:
        lib.otedama_sha256d_verify = real
    check(failed is not None and "CUDA error 1 (" in failed
          and sc.verify_launches.value == before,
          f"the injected failure did not raise as a failed launch: {failed}")
    for name in ("the launch after a failed one", "the launch after that"):
        versus_plain(name, None, None, count, 16, tensors=(w_all, t_all))
    print(f"   injected: {failed}", flush=True)
    # inputs the kernel cannot read in place raise, and launch nothing
    flat = on_card(np.zeros(20 * 9 + 1, dtype=np.uint32))
    for name, bad in (("misaligned", (flat[1:].view(9, 20), t_all[:9])),
                      ("non-contiguous", (w_all[:9], t_all[:18:2])),
                      ("int64", (w_all[:9], t_all[:9].long()))):
        try:
            sc.sha256d_verify(*bad, 9)
            raised = False
        except ValueError:
            raised = True
        check(raised and sc.verify_launches.value == before + 2,
              f"{name} inputs did not raise before any launch")
    print("   misaligned, non-contiguous and int64 inputs raise before any "
          "launch", flush=True)

    # -- 15. the scrypt verify path ----------------------------------------------
    phase("15 scrypt verify path vs plain version and hashlib, 1,024, 256, 37 "
          "and 1 lanes")
    scc.romix_launches.reset()
    # the ledger's shape: 1,024 lanes (four blocks of the epilogue), k = 16,
    # a planted failure in each block at v - 1, the rest at v + 1 or v
    headers = rng.integers(0, 256, (1024, 80), dtype=np.uint8)
    hl = limbs_of_digests(scrypt_values(headers))
    pattern = np.array([0, 1])[rng.integers(0, 2, 1024)]
    planted = np.sort(rng.integers(0, 256, 4) + 256 * np.arange(4))
    pattern[planted] = -1
    a = versus_plain("scrypt, 1,024 lanes, 4 planted failures",
                     st.headers_to_words(headers), boundary(hl, pattern), 1024,
                     16, scrypt=True)
    check(a[:4].tolist() == planted.tolist() and int(a[32]) == 4
          and a[16:20].tolist() == hl[planted, 0].tolist()
          and int(a[34]) == int(hl[:, 0].min()), "scrypt verify vs hashlib, 1,024 lanes")
    print(f"   failing lanes {planted.tolist()}, their top limbs and the min "
          f"top limb equal hashlib's", flush=True)
    headers = rng.integers(0, 256, (256, 80), dtype=np.uint8)
    hl = limbs_of_digests(scrypt_values(headers))
    pattern = np.array([0, -1, 1])[np.arange(256) % 3]
    a = versus_plain("scrypt, 256 lanes at v, v-1, v+1",
                     st.headers_to_words(headers), boundary(hl, pattern), 256,
                     128, scrypt=True)
    check(a[:85].tolist() == list(range(1, 256, 3)) and int(a[256]) == 85
          and int(a[258]) == int(hl[:, 0].min()), "scrypt verify vs hashlib")
    print("   the 85 failures and the min top limb equal hashlib's", flush=True)
    for count in (1, 37):       # less than a warp's lanes, and ragged
        headers = rng.integers(0, 256, (count, 80), dtype=np.uint8)
        hl = limbs_of_digests(scrypt_values(headers))
        pattern = np.array([0, -1, 1])[np.arange(count) % 3]
        a = versus_plain(f"scrypt, {count} lanes at v, v-1, v+1",
                         st.headers_to_words(headers), boundary(hl, pattern),
                         count, 16, scrypt=True)
        want = list(range(1, count, 3))
        check(a[:len(want)].tolist() == want and int(a[32]) == len(want)
              and int(a[34]) == int(hl[:, 0].min()),
              f"scrypt verify vs hashlib, {count} lanes")
        print(f"   {count} lanes: the {len(want)} failures and the min top limb "
              "equal hashlib's", flush=True)
    check(scc.romix_launches.value == 4, "the scrypt verify path ran no ROMix kernel")

    # -- 16. main path: the pool ledger ------------------------------------------
    phase("16 main path: PoolManager.on_share_batch -> ValidationBackend on the card")

    def byzantine_difficulty(v: int) -> float:
        """the float difficulty whose target is the largest below v"""
        s = (tgt.DIFF1_TARGET << 32) // v + 1
        while (tgt.DIFF1_TARGET << 32) // s >= v:
            s += 1
        return s / (1 << 32)

    def flush(algorithm, count, first):
        headers = rng.integers(0, 256, (count, 80), dtype=np.uint8)
        digests = (scrypt_values if algorithm == "scrypt" else sha256d_values)(headers)
        byz = rng.random(count) < 1 / 256
        batch, honest = [], []
        for i in range(count):
            d = digests[32 * i:32 * i + 32]
            v = int.from_bytes(d, "little")
            diff = (byzantine_difficulty(v) if byz[i]
                    else tgt.target_to_difficulty(v) * 0.5)
            honest.append(v <= tgt.difficulty_to_target(diff))
            batch.append(AcceptedShare(
                session_id=first + i, worker_user=f"w.{(first + i) % 4096}",
                job_id="ledger", difficulty=diff, actual_difficulty=diff,
                digest=d, header=headers[i].tobytes(),
                extranonce2=struct.pack(">I", first + i), ntime=1_700_000_000,
                nonce_word=0, is_block=False, submitted_at=1_700_000_000.0,
                algorithm=algorithm))
        return batch, honest

    t0 = time.monotonic()
    sha_flushes = [flush("sha256d", 1024, 1024 * f) for f in range(64)]
    sha_flushes.append(flush("sha256d", 64, 1 << 20))
    scrypt_flushes = [flush("scrypt", 1024, (1 << 21) + 1024 * f) for f in range(4)]
    print(f"   {64 * 1024 + 64} sha256d and {4 * 1024} scrypt shares built and "
          f"hashed by hashlib in {time.monotonic() - t0:.1f} s", flush=True)
    pm = PoolManager(connect_database(":memory:"), MockChainClient())
    pm.validator = ValidationBackend(min_batch=128, tripwire_rate=0.05, seed=SEED)
    for counter in (sc.verify_launches, scc.verify_launches, scc.romix_launches,
                    st.calls, sct.calls):
        counter.reset()

    async def producer(pm, flushes, outcomes, seconds):
        for batch, _ in flushes:
            t = time.monotonic()
            outcomes.append(await pm.on_share_batch(batch))
            seconds.append(time.monotonic() - t)

    async def ledger(pm, *producers):
        """each list of flushes from a producer of its own, all at once;
        returns each one's (outcomes, seconds per flush) and the wall time"""
        outs = [([], []) for _ in producers]
        t = time.monotonic()
        await asyncio.gather(*(producer(pm, f, *o)
                               for f, o in zip(producers, outs)))
        return outs, time.monotonic() - t

    def flush_rates(seconds):
        """shares/s of each 1,024-share sha256d flush: median, min, max"""
        rates = sorted(1024 / x for x in seconds[:64])
        return f"median {rates[32]:.1f}, min {rates[0]:.1f}, max {rates[-1]:.1f}"

    # the sha256d ledger and a second producer (the scrypt flushes)
    # dispatch at once, as two pool front ends would
    ((sha_out, sha_s), (scrypt_out, _)), seconds = asyncio.run(
        ledger(pm, sha_flushes, scrypt_flushes))
    b2_launches = sc.verify_launches.value
    verify_launches = scc.verify_launches.value
    romix_ledger = scc.romix_launches.value
    plain_calls = st.calls.value + sct.calls.value
    snap = pm.validator.snapshot()
    honest_total, shares = 0, 0
    for flushes, outs in ((sha_flushes, sha_out), (scrypt_flushes, scrypt_out)):
        for (batch, honest), outcomes in zip(flushes, outs):
            for ok, outcome in zip(honest, outcomes):
                check(outcome == (("ok", "") if ok else ("err", "share failed validation")),
                      f"ledger outcome {outcome} != hashlib's verdict {ok}")
            honest_total += sum(honest)
            shares += len(batch)
    device_shares = 68 * 1024
    check(pm.shares.count() == honest_total
          and pm.ledger_stats == {"batches": 69, "shares_ok": honest_total,
                                  "shares_rejected": shares - honest_total},
          f"books: {pm.shares.count()} shares, {pm.ledger_stats}, honest "
          f"{honest_total}")
    check(snap["device_batches"] == 68 and snap["crossover_batches"] == 1
          and snap["validated_device"] == device_shares
          and snap["device_errors"] == 0 and snap["tripwire_mismatches"] == 0
          and snap["overflows"] == 0 and snap["tripwire_checks"] > 68,
          f"validator snapshot {snap}")
    check(b2_launches == 64, f"B2 launched {b2_launches} times, not 64")
    check(verify_launches == romix_ledger == 4,
          f"scrypt verify launches {verify_launches}, ROMix {romix_ledger}")
    check(plain_calls == 0, f"the ledger called a plain version {plain_calls} times")
    ds = snap["device_seconds"]
    print(f"   {shares} shares in {seconds:.2f} s = {shares / seconds:.0f} shares/s "
          f"through on_share_batch ({len(sha_flushes)} sha256d and "
          f"{len(scrypt_flushes)} scrypt flushes, two producers at once); "
          f"every outcome = hashlib's verdict; books: {pm.shares.count()} "
          f"shares = the honest ones, {shares - honest_total} rejected; "
          f"validator: device batches {snap['device_batches']}, crossover "
          f"{snap['crossover_batches']}, validated on the card "
          f"{snap['validated_device']}, tripwire checks "
          f"{snap['tripwire_checks']}, mismatches "
          f"{snap['tripwire_mismatches']}, device errors "
          f"{snap['device_errors']}, overflows {snap['overflows']}; "
          f"device_seconds p50 {ds['p50_ms']:.3f} ms, p99 {ds['p99_ms']:.3f} ms "
          f"(histogram buckets), mean {ds['avg_ms']:.3f} ms; B2 launches "
          f"{b2_launches}, scrypt verify launches {verify_launches}, ROMix "
          f"launches {romix_ledger}, plain-version calls {plain_calls}",
          flush=True)
    print(f"   per sha256d flush of 1,024, shares/s over the 64 flushes beside "
          f"the scrypt producer: {flush_rates(sha_s)}", flush=True)
    del pm

    # outside the counted run: the sha256d flushes alone, on a fresh ledger
    pm = PoolManager(connect_database(":memory:"), MockChainClient())
    pm.validator = ValidationBackend(min_batch=128, tripwire_rate=0.05, seed=SEED)
    ((alone_out, alone_s),), alone = asyncio.run(ledger(pm, sha_flushes))
    check(alone_out == sha_out, "the sha256d flushes alone gave other outcomes")
    n_sha = sum(len(b) for b, _ in sha_flushes)
    print(f"   sha256d flushes alone: {n_sha} shares in {alone:.3f} s = "
          f"{n_sha / alone:.1f} shares/s; per flush {flush_rates(alone_s)}; "
          f"device_seconds {pm.validator.snapshot()['device_seconds']}", flush=True)
    del pm

    # an overflowed batch (one Byzantine share in three, past k = 16) is
    # settled on the card: B2 again with a slot for every failure
    headers = rng.integers(0, 256, (1024, 80), dtype=np.uint8)
    hl = limbs_of_digests(sha256d_values(headers))
    third = np.array([0, -1, 1])[rng.integers(0, 3, 1024)]
    tl = boundary(hl, third)
    validator = ValidationBackend(min_batch=128, tripwire_rate=0.05, seed=SEED)
    sc.verify_launches.reset()
    verdicts = asyncio.run(validator.verify_batch([
        ShareCheck(headers[i].tobytes(), tgt.limbs_to_target(tl[i]))
        for i in range(1024)]))
    snap = validator.snapshot()
    check(verdicts == (third != -1).tolist(), "overflowed batch: verdicts != hashlib's")
    check(snap["overflows"] == 1 and snap["device_batches"] == 1
          and snap["host_batches"] == 0 and snap["device_errors"] == 0
          and snap["tripwire_mismatches"] == 0 and sc.verify_launches.value == 2,
          f"overflowed batch: snapshot {snap}, B2 launches {sc.verify_launches.value}")
    print(f"   overflowed batch: {int((third == -1).sum())} failures of 1,024 past "
          f"k = 16, settled by a second B2 launch; verdicts = hashlib's", flush=True)
    torch.cuda.empty_cache()

    # -- 17. times ---------------------------------------------------------------
    phase("17 B2 and scrypt verify times")
    stream = torch.cuda.Stream(dev)
    headers = rng.integers(0, 256, (1 << 20, 80), dtype=np.uint8)
    w_all = on_card(st.headers_to_words(headers))
    t_all = on_card(np.full((1 << 20, 8), full, dtype=np.uint32))
    torch.cuda.synchronize(dev)
    def device_ms(fn, reps):
        """as median_ms, but each round starts behind a ~10 ms spin kernel
        during which the host enqueues the round's calls: the card's time
        a call back to back, the host's enqueue hidden"""
        rounds = []
        with torch.cuda.stream(stream):
            fn()
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(20_000_000)
                start.record(stream)
                for _ in range(reps):
                    fn()
                stop.record(stream)
                stop.synchronize()
                rounds.append(start.elapsed_time(stop) / reps)
        return sorted(rounds)[1], rounds

    # the latency floor under any one-launch call: an empty kernel's
    # launch to completion, and B2's own on one lane (each launched alone
    # between two events, host enqueue included; and back to back on the
    # card, the enqueue hidden)
    def alone_ms(fn, reps=50):
        times = []
        with torch.cuda.stream(stream):
            fn()
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                fn()
                stop.record(stream)
                stop.synchronize()
                times.append(start.elapsed_time(stop))
        return sorted(times)[reps // 2]

    out = torch.empty(sc.winner_buffer_words(16), dtype=torch.int32, device=dev)
    w1, t1 = w_all[:1], t_all[:1]
    floor = {
        "empty kernel": (alone_ms(lambda: sc.empty_launch(stream)),
                         device_ms(lambda: sc.empty_launch(stream), 50)[0]),
        "B2, 1 lane": (alone_ms(lambda: sc.sha256d_verify(
            w1, t1, 1, stream=stream, out=out)), device_ms(
            lambda: sc.sha256d_verify(w1, t1, 1, stream=stream, out=out),
            50)[0]),
    }
    print("   latency floor, ms: " + "; ".join(
        f"{name} {a:.4f} alone (launch to completion), {b:.4f} back to back "
        f"on the card" for name, (a, b) in floor.items()) + f"; {card}",
        flush=True)

    marks_seen: list = []

    def device_kernels(fn, calls=10, lead=32, trail=2):
        """the device kernels and copies that ``calls`` calls of ``fn``
        ran, by name, from torch.profiler (None when it saw no device
        activity). The calls sit between ``lead`` empty kernels before
        and ``trail`` after: on some hosts the profiler loses the first
        records of a trace (up to 11 seen), and those are then
        markers'. The markers are taken out by name, unless there are
        more of them than were launched as markers. ``marks_seen`` gets
        the markers seen before and after the calls"""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                sc.empty_launch(stream)
            torch.cuda.synchronize(dev)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(dev)
            for _ in range(trail):
                sc.empty_launch(stream)
            torch.cuda.synchronize(dev)
        names: dict[str, int] = {}
        starts: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
                starts.setdefault(e.name, []).append(e.time_range.start)
        marked = [n for n in names if "empty_kernel" in n]
        rest = [t for n in names if n not in marked for t in starts[n]]
        at = [t for n in marked for t in starts[n]]
        first = min(rest, default=float("inf"))
        marks_seen[:] = [sum(t < first for t in at),
                         sum(t >= first for t in at)]
        for name in marked:
            if names[name] <= lead + trail:
                del names[name]
        return names or None

    b2 = {}
    for lanes in (128, 1024, 4096, 1 << 20):
        w, t = w_all[:lanes], t_all[:lanes]
        torch.cuda.synchronize(dev)
        call = lambda: sc.sha256d_verify(w, t, lanes, stream=stream, out=out)  # noqa: E731
        ms, rounds = median_ms(call, stream, 200 if lanes < 1 << 20 else 20)
        card_ms, card_rounds = device_ms(call, 50 if lanes < 1 << 20 else 5)
        # the host's enqueue of one call, as the ledger makes it (no wait)
        enqueue = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(100):
                call()
            enqueue.append((time.perf_counter() - t0) * 1e4)
        torch.cuda.synchronize(dev)
        before = sc.verify_launches.value
        dropped = ""
        for attempt in range(PROFILE_ATTEMPTS):
            try:
                ran = device_kernels(call)
            except Exception as exc:        # the profiler is optional here
                ran = f"not measured ({type(exc).__name__}: {exc})"
            if not isinstance(ran, dict):
                break
            kernels = {n: c / 10 for n, c in ran.items()}
            only_b2 = (len(kernels) == 1
                       and "verify_kernel" in next(iter(kernels)))
            if (only_b2 and next(iter(kernels.values())) < 1
                    and attempt < PROFILE_ATTEMPTS - 1):
                # the profiler lost kernel records (it saw fewer kernels
                # than the wrapper launched): measure again
                dropped += (f" (profile {attempt + 1} saw "
                            f"{next(iter(kernels.values())):.1f} a call, "
                            f"markers before and after {marks_seen})")
                continue
            break
        launches = (sc.verify_launches.value - before) / (10 * (attempt + 1))
        if isinstance(ran, dict):
            check(only_b2 and next(iter(kernels.values())) == 1,
                  f"B2 call ran {kernels} on the card, not one verify kernel")
            ran = (f"one verify kernel and nothing else a call "
                   f"({next(iter(kernels))}){dropped}; empty-kernel markers"
                   f" seen before and after the calls {marks_seen} of "
                   f"[32, 2]")
        elif ran is None:
            ran = "not measured (torch.profiler saw no device activity)"
        t0 = time.monotonic()
        st.sha256d_verify_step(w, t, lanes - 1, k=16)
        torch.cuda.synchronize(dev)
        plain = (time.monotonic() - t0) * 1e3
        ops_ms = sc.verify_ops_per_share() * lanes / int_ops_per_s * 1e3
        bytes_ms = (sc.verify_bytes_per_share() * lanes
                    + sc.winner_buffer_words(16) * 4) / HBM_BYTES_PER_S * 1e3
        b2[lanes] = (ms, plain, max(ops_ms, bytes_ms),
                     "operations" if ops_ms >= bytes_ms else "bytes")
        print(f"   B2 {lanes} lanes: {ms:.4f} ms a call (rounds "
              + ", ".join(f"{r:.4f}" for r in rounds)
              + f") = {lanes / ms * 1e3:.3e} shares/s; on the card back "
              f"to back, the enqueue hidden, {card_ms:.4f} ms (rounds "
              + ", ".join(f"{r:.4f}" for r in card_rounds)
              + "); host enqueue "
              + ", ".join(f"{e:.1f}" for e in enqueue)
              + f" us a call; {launches:g} kernel launch a call by the "
              f"wrapper's count, the profiler: {ran}; bound "
              f"{b2[lanes][2]:.5f} ms ({b2[lanes][3]}: "
              f"{sc.verify_ops_per_share()} int32 ops, "
              f"{sc.verify_bytes_per_share()} B a share), "
              f"{b2[lanes][2] / ms:.1%} of it; latency floor "
              f"{floor['empty kernel'][0]:.4f} ms (empty kernel), "
              f"{floor['B2, 1 lane'][0]:.4f} ms (B2 on 1 lane); plain "
              f"version {plain:.1f} ms; {card}", flush=True)
    for lanes in (1024, 4096):
        w, t = w_all[:lanes].contiguous(), t_all[:lanes].contiguous()
        scratch = (torch.empty(scc.ROW_WORDS * lanes, dtype=torch.int32, device=dev),
                   torch.empty(scc.scratch_words(lanes), dtype=torch.int32, device=dev))
        torch.cuda.synchronize(dev)
        ms, rounds = median_ms(lambda: scc.scrypt_verify(
            w, t, lanes, scratch=scratch, stream=stream), stream, 3)
        ops_ms = scc.ops_per_hash() * lanes / int_ops_per_s * 1e3
        bytes_ms = ((scc.v_bytes_per_hash() + sc.verify_bytes_per_share())
                    * lanes / HBM_BYTES_PER_S * 1e3)
        print(f"   scrypt verify {lanes} lanes: {ms:.3f} ms (rounds "
              + ", ".join(f"{r:.3f}" for r in rounds)
              + f") = {lanes / ms * 1e3:.0f} shares/s; bound "
              f"{max(ops_ms, bytes_ms):.4f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}: "
              f"{scc.ops_per_hash():.0f} int32 ops and "
              f"{scc.v_bytes_per_hash() + sc.verify_bytes_per_share()} B a share); "
              f"{card}", flush=True)
    del w_all, t_all
    torch.cuda.empty_cache()

    # where verify_batch on the card overtakes host validation: whole calls
    # (the dispatch, its read-back and the tripwire's host sample, at the
    # default 5%) against the host path on the validation executor
    async def batch_ms(backend, checks, reps):
        await backend.verify_batch(checks)
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            await backend.verify_batch(checks)
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[reps // 2]

    async def crossover(algorithm, sizes, reps):
        on_card = ValidationBackend(min_batch=1, seed=SEED)
        on_host = ValidationBackend(device=None, seed=SEED)
        headers = rng.integers(0, 256, (max(sizes), 80), dtype=np.uint8)
        rows = []
        for n in sizes:
            checks = [ShareCheck(h.tobytes(), (1 << 256) - 1, algorithm)
                      for h in headers[:n]]
            rows.append((n, await batch_ms(on_card, checks, reps),
                         await batch_ms(on_host, checks, reps)))
        return rows

    for algorithm, sizes, reps in (
            ("sha256d", tuple(1 << i for i in range(11)), 21),
            ("scrypt", (1, 2, 4, 8, 16, 32, 64), 5)):
        rows = asyncio.run(crossover(algorithm, sizes, reps))
        wins = [n for n, card_ms, host_ms in rows if card_ms <= host_ms]
        at = next((n for n in sizes if all(m in wins for m in sizes if m >= n)),
                  None)
        print(f"   verify_batch {algorithm}, median ms of {reps} calls, card vs "
              f"host: " + "; ".join(f"{n}: {c:.4f} vs {h:.4f}" for n, c, h in rows)
              + f"; the card is as fast from {at} shares a batch; {card}",
              flush=True)

    ms, plain, bound, by = b2[1024]       # the ledger's flush size
    record = {
        "name": "sha256d_verify",
        "route": "cuda",
        "source": "otedama_tpu_torch/kernels/csrc/sha256d.cu",
        "replaces": "otedama_tpu/kernels/sha256_pallas.py:451",
        "launches": b2_launches,
        "max_abs_err": max_err["B2"],
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "path": "pool ledger on_share_batch (phase 16)",
    }
    return record, romix_ledger, max_err["scrypt"]


# -- phases 18-21: supervision, a real stall, warm switching, the RPC client --

# tight supervision knobs: a blown deadline within seconds on the card.
# One 2^31-nonce launch a group: with the default groups (two launches,
# two groups in flight) a call's duration includes its wait behind the
# group before it on the stream, and doubles while a relayout leaves the
# cancelled searcher's groups queued, so a 3x deadline quarantined a
# healthy device on the card
SUPERVISION = dict(watchdog_floor=2.0, watchdog_multiplier=3.0,
                   watchdog_min_samples=1, watchdog_first_deadline=10.0,
                   probe_timeout=5.0, probe_backoff=2.0, probe_backoff_max=4.0,
                   max_probes=20, drain_timeout=3.0, pipeline_depth=1)
SUPERVISED_TARGET = 1 << 228  # ~8 winners a 2^31-nonce launch, under k = 16
SCRYPT_SHARE_TARGET = 1 << 240  # ~1 scrypt share per 2^16 hashes
MIB = 1 << 20


async def until(cond, timeout: float, what: str) -> float:
    """Poll ``cond`` every 5 ms; the instant it held."""
    t_end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < t_end, f"timed out after {timeout:.0f} s "
              f"waiting for {what}")
        await asyncio.sleep(0.005)
    return time.monotonic()


class Timeline:
    """Polled every 5 ms on the engine's loop: the instants at which the
    engine's hash count moves (once a drained device call) and at which
    each device's supervision state changes."""

    def __init__(self, engine):
        self.engine = engine
        self.moves: list[tuple[float, int]] = []
        self.states: list[tuple[float, str, str]] = []
        self._task = asyncio.get_running_loop().create_task(self._poll())

    async def _poll(self):
        last_h, last_state = None, {}
        while True:
            now, h = time.monotonic(), self.engine.stats.hashes
            if h != last_h:
                self.moves.append((now, h))
                last_h = h
            for name, sup in list(self.engine.supervisors.items()):
                if last_state.get(name) != sup.state.value:
                    last_state[name] = sup.state.value
                    self.states.append((now, name, sup.state.value))
            await asyncio.sleep(0.005)

    def stop(self):
        self._task.cancel()

    def entries(self, name: str, state: str, t0: float, t1: float) -> list:
        return [t for t, n, s in self.states
                if n == name and s == state and t0 <= t <= t1]

    def rate(self, t0: float, t1: float) -> str:
        """The engine's H/s between the first and the last drained call in
        [t0, t1]."""
        inside = [(t, h) for t, h in self.moves if t0 <= t <= t1]
        if len(inside) < 2:
            return f"not measured ({len(inside)} drained calls)"
        (ta, ha), (tb, hb) = inside[0], inside[-1]
        return (f"{(hb - ha) / (tb - ta) / 1e9:.3f} GH/s ({hb - ha} hashes "
                f"in {tb - ta:.2f} s, {len(inside)} drained calls)")


class Harness:
    """A card backend as the engine sees it, with what the harness needs
    around it: each group call's header (its job and extranonce2) is
    recorded by device, and while ``stalls_left`` > 0 a search or group
    call first enqueues a ``torch.cuda._sleep`` spin of ``stall_cycles``
    on the backend's stream (a real device-side stall; precompile never
    spins)."""

    def __init__(self, backend, calls: list, stall_cycles: int = 0):
        self.backend, self.calls = backend, calls
        self.name = backend.name
        self.preferred_batch = backend.preferred_batch
        self.stall_cycles, self.stalls_left = stall_cycles, 0
        self.spins: list = []          # (enqueued at, event after the spin)
        self._lock = threading.Lock()

    def _stall(self):
        import torch

        with self._lock:
            if self.stalls_left <= 0:
                return
            self.stalls_left -= 1
        b = self.backend
        with torch.cuda.device(b.device), torch.cuda.stream(b.stream):
            torch.cuda._sleep(self.stall_cycles)
            done = torch.cuda.Event()
            done.record(b.stream)
        self.spins.append((time.monotonic(), done))

    def search_group(self, jc, batches):
        self.calls.append((self.name, jc.header76))
        self._stall()
        return self.backend.search_group(jc, batches)

    def search(self, jc, base, count):
        self._stall()
        return self.backend.search(jc, base, count)

    def precompile(self, jc=None, count=None):
        return self.backend.precompile(jc, count)

    def close(self, timeout: float = 30.0):
        self.backend.close(timeout)


def smoke_job(job_id: str, algorithm: str = "sha256d",
              share_target: int = SUPERVISED_TARGET):
    from otedama_tpu_torch.engine.types import Job

    return Job(job_id=job_id, prev_hash=hashlib.sha256(job_id.encode()).digest(),
               coinb1=bytes.fromhex("01000000010000000000000000"),
               coinb2=bytes.fromhex("ffffffff0100f2052a01000000"),
               merkle_branch=[], version=0x20000000, nbits=0x1D00FFFF,
               ntime=1_700_000_000, extranonce1=b"", extranonce2_size=4,
               share_target=share_target, algorithm=algorithm)


def check_shares(shares, jobs: dict) -> int:
    """Every share re-hashed with hashlib (sha256d or scrypt, by its job's
    algorithm; x11 through the port's host chain): the digest the engine reported, at or under its job's
    share target, and no (job, extranonce2, nonce) twice. Returns the
    count."""
    from otedama_tpu_torch.engine.jobs import header_from_share

    seen = set()
    for s in shares:
        key = (s.job_id, s.extranonce2, s.nonce_word)
        check(key not in seen, f"duplicate share {key}")
        seen.add(key)
        job = jobs[s.job_id]
        header = header_from_share(job, s.extranonce2, s.ntime, s.nonce_word)
        if job.algorithm == "scrypt":
            value = scrypt_value(header)
        elif job.algorithm == "x11":
            value = x11_value(header)
        else:
            value = int.from_bytes(
                hashlib.sha256(hashlib.sha256(header).digest()).digest(),
                "little")
        check(value.to_bytes(32, "little") == s.digest
              and value <= job.share_target,
              f"share {key} fails its hashlib re-check")
    return len(seen)


def supervision_phases(dev, card: str, clock_mhz: float) -> dict:
    """Phases 18 (supervision under injected faults) and 19 (a real
    device-side stall). Returns the B1 launches of their runs."""
    import torch

    from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
    from otedama_tpu_torch.engine.jobs import job_constants
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.runtime import supervision
    from otedama_tpu_torch.runtime.search import CudaBackend
    from otedama_tpu_torch.utils import faults

    def card_backends(calls, stall_cycles=0):
        out = {}
        for i in range(2):
            b = CudaBackend(dev)
            b.name = f"cuda{i}"       # the class's name is "cuda"
            b.precompile(count=MAIN_BATCH)
            out[b.name] = Harness(b, calls, stall_cycles)
        return out

    out = {}

    # -- 18. supervision on the card ---------------------------------------------
    phase("18 supervision on the card: cuda0 and cuda1 (two backends, one "
          "card), an injected hang, quarantine, verified probes")
    calls, shares, jobs = [], [], {}
    spans = {}      # job -> the calls made while both devices mined it

    async def on_share(s):
        shares.append(s)

    async def run18():
        engine = MiningEngine(card_backends(calls), on_share=on_share,
                              config=EngineConfig(**SUPERVISION))

        def new_job(job_id):
            jobs[job_id] = smoke_job(job_id)
            engine.set_job(jobs[job_id])

        await engine.start()
        tl = Timeline(engine)
        sup1 = engine.supervisors["cuda1"]
        try:
            new_job("s18-a")
            await until(lambda: all(s.call_hist.count >= 3 for s in
                                    engine.supervisors.values()), 60,
                        "three calls on each device")
            t_both = time.monotonic()
            await asyncio.sleep(4.0)
            deadline = sup1.deadline(MAIN_BATCH)
            call_s = max(sup.call_hist.sum / sup.call_hist.count
                         for sup in engine.supervisors.values())
            inj = faults.FaultInjector(SEED).delay(
                "device.call:cuda1", seconds=8.0, window=(0.0, 3.0))
            relayouts = engine.snapshot()["relayouts"]
            with faults.active(inj):
                t_act = time.monotonic()
                spans["s18-a"] = (0, len(calls))
                t_q = await until(lambda: not sup1.can_mine, 30,
                                  "cuda1's quarantine")
                await until(lambda: engine.snapshot()["relayouts"] > relayouts,
                            30, "the relayout")
                relayouts = engine.snapshot()["relayouts"]
                new_job("s18-q")
                health = engine.device_health()
                check(health["status"] == "degraded"
                      and health["active_devices"] == 1,
                      f"health while cuda1 is out: {health}")
                h0 = engine.stats.devices["cuda0"].hashes
                t_r = await until(lambda: sup1.state.value == "healthy", 60,
                                  "cuda1's reintegration")
                check(engine.stats.devices["cuda0"].hashes > h0,
                      "cuda0 stopped mining while cuda1 was out")
            await until(lambda: engine.snapshot()["relayouts"] > relayouts,
                        30, "the relayout")
            new_job("s18-b")
            b_start, t_b = len(calls), time.monotonic()
            await asyncio.sleep(4.0)
            t_after = time.monotonic()
            check(engine.snapshot()["relayouts"] >= 2, "fewer than 2 relayouts")
            window_end = t_act + 3.0
            probes_after = tl.entries("cuda1", "probing", window_end, t_r)
            check(1 <= len(probes_after) <= 2,
                  f"{len(probes_after)} probes after the fault window closed")
            check(t_q - t_act <= deadline + call_s + 1.0,
                  f"quarantine {t_q - t_act:.2f} s after the fault, deadline "
                  f"{deadline:.2f} s, a call {call_s:.2f} s")
            print(f"   deadline {deadline:.2f} s (a call {call_s:.2f} s on the "
                  f"shared card); cuda1 quarantined {t_q - t_act:.2f} s "
                  f"after the fault began, reintegrated {t_r - window_end:.2f}"
                  f" s after its window closed ({len(probes_after)} probe(s) "
                  f"after it, {sup1.probes} in all); relayouts "
                  f"{engine.snapshot()['relayouts']}", flush=True)
            print(f"   rate, both devices: {tl.rate(t_both, t_act)}",
                  flush=True)
            print(f"   rate, cuda0 alone: {tl.rate(t_q, t_r)}", flush=True)
            print(f"   rate, both again: {tl.rate(t_b + 1.0, t_after)}",
                  flush=True)
            out["quarantine_s"] = t_q - t_act
            out["reintegration_s"] = t_r - window_end

            # corrupt results: the probes must fail the host oracle until
            # the window closes
            engine.config.probe_backoff = 0.5
            engine.config.probe_backoff_max = 1.0
            corrupt_s = 6.0
            inj = (faults.FaultInjector(SEED + 1)
                   .delay("device.call:cuda1", seconds=8.0, once=True)
                   .corrupt("device.call:cuda1", window=(0.0, corrupt_s)))
            probes0 = sup1.probes
            with faults.active(inj):
                t_act = time.monotonic()
                spans["s18-b"] = (b_start, len(calls))
                await until(lambda: not sup1.can_mine, 30, "quarantine")
                new_job("s18-c")
                await until(lambda: sup1.probes_failed >= 1, 30,
                            "a corrupt probe rejected")
                check("oracle" in (sup1.last_error or ""),
                      f"probe failure: {sup1.last_error}")
                t_r = await until(lambda: sup1.state.value == "healthy", 60,
                                  "reintegration after the corrupt window")
            check(t_r >= t_act + corrupt_s,
                  "a probe verified inside the corrupt window")
            print(f"   corrupt window {corrupt_s:.0f} s: "
                  f"{sup1.probes - probes0 - 1} probe(s) failed the host "
                  f"oracle, reintegrated {t_r - t_act - corrupt_s:.2f} s after "
                  "the window closed", flush=True)

            # stop() with a call hung for good
            inj = faults.FaultInjector(SEED + 2).delay("device.call:cuda*",
                                                       seconds=12.0)
            with faults.active(inj):
                await until(lambda: inj.rules[0].fires >= 1, 30, "a hung call")
                abandoned = engine.snapshot()["abandoned_calls"]
                t0 = time.monotonic()
                await engine.stop()
                stop_s = time.monotonic() - t0
            abandoned = engine.snapshot()["abandoned_calls"] - abandoned
            check(stop_s <= SUPERVISION["drain_timeout"] + 1.0,
                  f"stop() took {stop_s:.2f} s with a hung call")
            check(abandoned >= 1, "stop() abandoned no call")
            print(f"   stop() with a hung call: {stop_s:.2f} s (drain timeout"
                  f" {SUPERVISION['drain_timeout']:.0f} s), {abandoned} "
                  "call(s) abandoned by it", flush=True)
        finally:
            tl.stop()
            await engine.close()
        return engine

    sc.launches.reset()
    engine = asyncio.run(run18())
    out["launches"] = sc.launches.value
    n = check_shares(shares, jobs)
    # while both devices mined a job, their extranonce2 blocks are disjoint
    # (a respawned searcher starts its block again, so a job that spans a
    # relayout is mined twice over in part: the engine emits its shares once)
    headers = {}
    for job_id in spans:
        for en2 in range(1024):
            e = en2.to_bytes(4, "big")
            headers[job_constants(jobs[job_id], e).header76] = (job_id, en2)
    for job_id, (i0, i1) in spans.items():
        by_dev = {name: {headers[h][1] for d, h in calls[i0:i1]
                         if d == name and headers.get(h, ("",))[0] == job_id}
                  for name in ("cuda0", "cuda1")}
        check(all(by_dev.values()) and not by_dev["cuda0"] & by_dev["cuda1"],
              f"job {job_id}: extranonce2 blocks {by_dev}")
        print(f"   job {job_id}: extranonce2 cuda0 {sorted(by_dev['cuda0'])}, "
              f"cuda1 {sorted(by_dev['cuda1'])}: disjoint", flush=True)
    print(f"   {n} shares re-hashed with hashlib, at or under their targets, "
          f"none twice; B1 launches {out['launches']}", flush=True)

    # one probe's launches, overflow included
    pb = CudaBackend(dev)
    sc.launches.reset()
    jc, res, base, count = engine._probe_search(pb)
    probe_launches = sc.launches.value
    expect = supervision.expected_probe_winners("sha256d", jc, base, count)
    check(supervision.verify_probe_results("sha256d", jc, res, base, count),
          "the sha256d probe failed the hashlib oracle")
    pb.close()
    print(f"   a sha256d probe: {probe_launches} B1 launches (1 warmup of "
          f"{MAIN_BATCH}, 1 of {count} nonces, {probe_launches - 2} for the "
          f"bisect: {len(expect)} winners against k = {sc.K_WINNERS}), "
          "verified against hashlib; " + card, flush=True)
    out["probe_launches"] = probe_launches

    # -- 19. a real stall on the card -----------------------------------------------
    phase("19 a real stall: a torch.cuda._sleep spin on cuda1's stream")
    spin_s = 4.0
    calls.clear()

    async def run19():
        loop = asyncio.get_running_loop()
        backends = card_backends(calls, int(spin_s * clock_mhz * 1e6))
        stall = backends["cuda1"]
        engine = MiningEngine(
            backends, config=EngineConfig(**{**SUPERVISION,
                                             "probe_backoff": 0.5}))
        await engine.start()
        tl = Timeline(engine)
        sup1 = engine.supervisors["cuda1"]
        try:
            engine.set_job(smoke_job("s19"))
            await until(lambda: all(s.call_hist.count >= 3 for s in
                                    engine.supervisors.values()), 60,
                        "three calls on each device")
            deadline = sup1.deadline(MAIN_BATCH)
            stall.stalls_left = 1
            t_arm = time.monotonic()
            t_q = await until(lambda: not sup1.can_mine, 30,
                              "the watchdog on the spin")
            t0 = time.monotonic()
            alive = await loop.run_in_executor(
                None, supervision.probe_cuda_devices, [torch.device("cuda")],
                10.0)
            census_s = time.monotonic() - t0
            check(alive == [torch.device("cuda")], f"census: {alive}")
            h0 = engine.stats.devices["cuda0"].hashes
            spun_at, spin_done = stall.spins[0]
            t_spun = await until(spin_done.query, 30, "the spin's end")
            t_r = await until(lambda: sup1.state.value == "healthy", 60,
                              "reintegration after the spin")
            check(engine.stats.devices["cuda0"].hashes > h0,
                  "cuda0 stopped mining during the stall")
            t_p = tl.entries("cuda1", "probing", t_q, t_r)
            check(sup1.probes == 1 and t_p and t_p[0] < t_spun <= t_r,
                  f"probes {sup1.probes}, probing at {t_p}, spin end "
                  f"{t_spun - t_arm:.2f} s, healthy {t_r - t_arm:.2f} s")
            print(f"   deadline {deadline:.2f} s; spin of {spin_s:.0f} s "
                  f"enqueued {spun_at - t_arm:.2f} s after arming; watchdog "
                  f"fired {t_q - spun_at:.2f} s after it; the probe began "
                  f"{t_p[0] - spun_at:.2f} s after it and waited behind the "
                  f"spin, which ended at {t_spun - spun_at:.2f} s; "
                  f"reintegrated at {t_r - spun_at:.2f} s; "
                  f"probe_cuda_devices([cuda]) answered in {census_s:.3f} s "
                  "during the stall; " + card, flush=True)
            out["stall"] = dict(watchdog_s=t_q - spun_at,
                                reintegrated_s=t_r - spun_at)
        finally:
            tl.stop()
            await engine.close()

    sc.launches.reset()
    asyncio.run(run19())
    out["launches"] += sc.launches.value
    print(f"   B1 launches {sc.launches.value}", flush=True)
    return out


def switch_phase(dev, card: str) -> dict:
    """Phase 20: warm switching sha256d <-> scrypt on the card. Returns the
    B1 and B5 launches of its run and the scrypt probe's."""
    import torch

    from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
    from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.runtime import supervision
    from otedama_tpu_torch.runtime.search import BackendClosedError

    phase("20 warm switching on the card: sha256d -> scrypt -> sha256d -> "
          "scrypt -> sha256d")
    manager = AlgorithmManager("cuda", device=str(dev))
    shares, jobs, rounds = [], {}, []
    out = {}

    async def on_share(s):
        shares.append(s)

    def memory():
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated(dev)

    async def run20():
        sha = manager.prepare_backend("sha256d", warm_count=MAIN_BATCH)
        engine = MiningEngine({sha.name: sha}, on_share=on_share,
                              config=EngineConfig())

        def new_job(job_id, algorithm):
            jobs[job_id] = smoke_job(
                job_id, algorithm,
                SCRYPT_SHARE_TARGET if algorithm == "scrypt"
                else SUPERVISED_TARGET)
            engine.set_job(jobs[job_id])

        await engine.start()
        try:
            new_job("s20-sha0", "sha256d")
            await asyncio.sleep(2.0)
            for rnd in (1, 2):
                before = memory()
                torch.cuda.reset_peak_memory_stats(dev)
                scrypt = await manager.prepare_backend_async(
                    "scrypt", warm_count=engine.planned_batch)
                down_in = await engine.switch_algorithm(
                    "scrypt", {scrypt.name: scrypt})
                new_job(f"s20-scrypt{rnd}", "scrypt")
                await asyncio.sleep(2.0)
                sha = await manager.prepare_backend_async(
                    "sha256d", warm_count=engine.planned_batch)
                down_out = await engine.switch_algorithm(
                    "sha256d", {sha.name: sha})
                check(engine.snapshot()["last_switch_downtime_seconds"]
                      == round(down_out, 6), "downtime not in the snapshot")
                after, peak = memory(), torch.cuda.max_memory_allocated(dev)
                try:
                    scrypt.search(supervision.probe_job_constants("scrypt"),
                                  0, 8)
                except BackendClosedError:
                    pass
                else:
                    check(False, "a closed scrypt backend took a call")
                new_job(f"s20-sha{rnd}", "sha256d")
                await asyncio.sleep(2.0)
                rounds.append(dict(before=before, after=after, peak=peak,
                                   down_in=down_in, down_out=down_out))
                check(abs(after - before) <= 256 * MIB,
                      f"round {rnd}: {after / MIB:.0f} MiB allocated after "
                      f"the switch away from scrypt, {before / MIB:.0f} before")
                check(max(down_in, down_out) < 0.5,
                      f"round {rnd}: downtime {down_in:.4f} / {down_out:.4f} s")
        finally:
            await engine.close()
        return engine

    sc.launches.reset()
    scc.romix_launches.reset()
    engine = asyncio.run(run20())
    out["b1_launches"], out["b5_launches"] = (sc.launches.value,
                                              scc.romix_launches.value)
    check(rounds[1]["peak"] <= rounds[0]["peak"] + 256 * MIB,
          f"peak {rounds[1]['peak'] / MIB:.0f} MiB in round 2 against "
          f"{rounds[0]['peak'] / MIB:.0f} in round 1")
    n = check_shares(shares, jobs)
    for rnd, r in enumerate(rounds, 1):
        print(f"   round {rnd}: downtime into scrypt {r['down_in'] * 1e3:.2f} "
              f"ms, back to sha256d {r['down_out'] * 1e3:.2f} ms; "
              f"memory_allocated {r['before'] / MIB:.1f} MiB before, "
              f"{r['after'] / MIB:.1f} after, max_memory_allocated "
              f"{r['peak'] / MIB:.1f}", flush=True)
    per_job = {job_id: sum(s.job_id == job_id for s in shares)
               for job_id in jobs}
    check(all(per_job.values()), f"a side mined no share: {per_job}")
    print(f"   shares by side: {per_job}", flush=True)
    print(f"   {n} shares re-hashed with hashlib (sha256d and scrypt); B1 "
          f"launches {out['b1_launches']}, B5 launches {out['b5_launches']};"
          f" closed backends refused calls; " + card, flush=True)

    # a scrypt probe through B5 on 256 lanes, against the hashlib oracle
    probe = manager.backend_for("scrypt")
    scc.romix_launches.reset()
    jc, res, base, count = engine._probe_search(probe)
    out["probe_launches"] = scc.romix_launches.value
    expect = supervision.expected_probe_winners("scrypt", jc, base, count)
    check(supervision.verify_probe_results("scrypt", jc, res, base, count),
          "the scrypt probe failed the hashlib oracle")
    probe.close()
    print(f"   a scrypt probe: {out['probe_launches']} B5 launches (warmup "
          f"{engine.planned_batch(probe)} lanes, then {count} lanes, "
          f"{len(expect)} winners against k = 16), verified against "
          "hashlib.scrypt", flush=True)
    return out


class MockNode:
    """A bitcoind-style JSON-RPC node on a loopback port, answering
    ``getblocktemplate``, ``submitblock``, ``getdifficulty`` and
    ``getblockheader`` from a ``MockChainClient``."""

    def __init__(self, chain):
        import http.server

        self.chain, self.calls, self.lock = chain, [], threading.Lock()
        node = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"      # keep-alive

            def do_POST(self):
                req = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                body = json.dumps({"id": req["id"], "error": None,
                                   "result": node.answer(req)}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/"

    def answer(self, req):
        method, params, chain = req["method"], req["params"], self.chain
        with self.lock:
            self.calls.append(method)
            if method == "getblocktemplate":
                t = asyncio.run(chain.get_block_template())
                return {"version": t.version, "height": t.height,
                        "previousblockhash": t.prev_hash[::-1].hex(),
                        "bits": f"{t.nbits:08x}", "curtime": t.ntime,
                        "coinbasevalue": t.reward, "transactions": []}
            if method == "submitblock":
                outcome = asyncio.run(chain.submit_block(
                    bytes.fromhex(params[0])))
                return None if outcome.accepted else outcome.reason
            if method == "getdifficulty":
                return asyncio.run(chain.get_network_difficulty())
            if method == "getblockheader":
                return {"confirmations": asyncio.run(
                    chain.get_confirmations(params[0]))}
        raise ValueError(f"unknown method {method}")

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def rpc_phase(dev, card: str) -> int:
    """Phase 21: the solo Application mining on the card against a node
    through BitcoinRPCClient. Returns the B1 launches of its run."""
    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.pool.blockchain import BitcoinRPCClient, MockChainClient

    phase("21 the chain RPC client: solo Application on the card against a "
          "loopback JSON-RPC node, difficulty 1")
    chain = MockChainClient(nbits=0x1D00FFFF)
    node = MockNode(chain)
    cfg = AppConfig()
    cfg.mining.device = str(dev)
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.5
    cfg.pool.chain_rpc_url = node.url
    cfg.pool.chain_rpc_user = "smoke"
    cfg.pool.chain_rpc_password = "smoke"
    app = Application(cfg)

    async def run21():
        await app.start()
        try:
            check(isinstance(app.chain, BitcoinRPCClient), "no RPC client")
            t0 = time.monotonic()
            while len(chain.submitted) < 2:
                check(time.monotonic() < t0 + MAIN_PATH_BOUND_S,
                      f"{len(chain.submitted)} blocks in "
                      f"{MAIN_PATH_BOUND_S:.0f} s")
                check(not any(t.done() and not t.cancelled() and t.exception()
                              for t in app._tasks), "a background task failed")
                await asyncio.sleep(0.05)
            snap = app.snapshot()
            check("failures" in snap and "recovery" in snap,
                  "supervision missing from the snapshot")
            return time.monotonic() - t0, app.chain.pool_snapshot()
        finally:
            await app.stop()
            node.close()

    sc.launches.reset()
    seconds, pool = asyncio.run(run21())
    target = tgt.bits_to_target(0x1D00FFFF)
    for height, header, block_hash in chain.submitted:
        d = hashlib.sha256(hashlib.sha256(header).digest()).digest()
        check(int.from_bytes(d, "little") <= target
              and d[::-1].hex() == block_hash,
              f"block {height} fails its hashlib re-check")
        print(f"   block {height} accepted through submitblock: {block_hash}",
              flush=True)
    check(pool["reused"] > 0, f"no keep-alive reuse: {pool}")
    print(f"   {len(chain.submitted)} blocks in {seconds:.2f} s; node calls "
          + ", ".join(f"{m} {node.calls.count(m)}" for m in sorted(set(node.calls)))
          + f"; connection pool {pool}; B1 launches {sc.launches.value}; "
          + card, flush=True)
    return sc.launches.value



# -- phases 22-25: the stratum pool and client on the card ----------------------

FLEET = 1000                  # raw-wire miners (the reference's stratum bench)
FLEET_CONNECT_RATE = 500.0    # connects a second
FLEET_SHARES = 3              # pre-mined shares a miner
FLEET_WINDOW_S = 10.0         # the submit window
# the fleet's sessions are retargeted to this difficulty (below vardiff's
# 0.001 floor) through the server's own retarget path, so the host
# pre-mines its 3,000 shares in a few seconds (about 430 hashes a share)
FLEET_DIFFICULTY = 1e-7
POOL_WORKER = "card.pool"
VARDIFF_START = 1 / 64        # ~32 winners a 2^31-nonce launch: over k = 16
FAILOVER_DIFFICULTY = 1 / 16  # ~8 winners a 2^31-nonce launch
WATCH_SPAN_S = 2.0  # phase 24 watches the engine this long each side of the stop
SCRYPT_POOL_DIFFICULTY = 2.0 ** -16   # one scrypt share per 2^16 hashes
SCRYPT_POOL_WINDOW_S = 10.0


def quantiles(values) -> str:
    if not values:
        return "none"
    v = sorted(values)
    return (f"p50 {v[len(v) // 2] * 1e3:.2f} ms, p99 "
            f"{v[min(len(v) - 1, int(len(v) * 0.99))] * 1e3:.2f} ms, max "
            f"{v[-1] * 1e3:.2f} ms (n={len(v)})")


def sha256d_value(header: bytes) -> int:
    return int.from_bytes(hashlib.sha256(hashlib.sha256(header).digest())
                          .digest(), "little")


def check_accepted(shares) -> None:
    """Every AcceptedShare the pool booked, re-hashed with hashlib (sha256d
    or scrypt by its algorithm): the digest the server computed, at or
    under the target of the difficulty it was credited at."""
    from otedama_tpu_torch.kernels import target as tgt

    for s in shares:
        value = (scrypt_value(s.header) if s.algorithm == "scrypt"
                 else sha256d_value(s.header))
        check(value.to_bytes(32, "little") == s.digest
              and value <= tgt.difficulty_to_target(s.difficulty),
              f"share of {s.worker_user} {s.job_id}/{s.nonce_word:#010x} "
              "fails its hashlib re-check")


def pool_app(algorithm: str, difficulty: float, chain, dev):
    """An ``Application`` configured as ``cli pool --mine`` sets it, on the
    card, on a loopback port with a throwaway ledger."""
    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig

    cfg = AppConfig()
    cfg.pool.enabled = True
    cfg.stratum.enabled = True
    cfg.mining.enabled = True
    cfg.mining.device = str(dev)
    cfg.mining.algorithm = algorithm
    cfg.mining.worker_name = POOL_WORKER
    cfg.pool.database = ":memory:"
    cfg.stratum.host = "127.0.0.1"
    cfg.stratum.port = 0
    cfg.stratum.initial_difficulty = difficulty
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.5
    return Application(cfg, chain=chain)


class Booked:
    """The server's share hook, counted: each share the ledger booked (its
    ``on_share`` returned), by worker."""

    def __init__(self, server, on_share):
        self.shares, self.on_share = [], on_share
        server.on_share = self

    async def __call__(self, share):
        await self.on_share(share)
        self.shares.append(share)

    def by_worker(self) -> dict:
        out: dict = {}
        for s in self.shares:
            out[s.worker_user] = out.get(s.worker_user, 0) + 1
        return out


class Gate:
    """The engine's share hook with a cut: once closed, shares found are
    counted and not submitted, so that when no submit is in flight every
    share the card submitted has its verdict (stopping the engine instead
    cancels a submit whose line is already on the wire: booked, its
    verdict never read)."""

    def __init__(self, engine):
        self.on_share, self.open, self.inflight, self.held = (
            engine.on_share, True, 0, 0)
        engine.on_share = self

    async def __call__(self, share):
        if not self.open:
            self.held += 1
            return
        self.inflight += 1
        try:
            await self.on_share(share)
        finally:
            self.inflight -= 1

    async def cut(self) -> None:
        self.open = False
        await until(lambda: self.inflight == 0, 60.0, "submits in flight")


async def engine_running(app, timeout: float = MAIN_PATH_BOUND_S) -> None:
    t_end = time.monotonic() + timeout
    while app.engine.state.value != "running":
        check(time.monotonic() < t_end, "the engine never started")
        check(not any(t.done() and not t.cancelled() and t.exception()
                      for t in app._tasks),
              "a background task failed before the engine started")
        await asyncio.sleep(0.05)


def lift_ip_caps(server) -> None:
    """A loopback fleet is one IP: lift the per-IP caps in the server's
    ``ServerConfig.ddos``, as the reference's stratum bench does, and keep
    the guard on the path. The loopback miner's live slot carries over."""
    from otedama_tpu_torch.security.ddos import DDoSConfig, DDoSProtection

    server.config = dataclasses.replace(server.config, ddos=DDoSConfig(
        max_concurrent_per_ip=1 << 20, connects_per_minute=1e12,
        bytes_per_window=1 << 40))
    server.ddos = DDoSProtection(server.config.ddos)
    for _ in server.sessions:
        check(server.ddos.allow_connect("127.0.0.1"), "ddos guard refused")


def raise_fd_limit(need: int) -> str:
    """The fleet's descriptors: the soft limit raised to the hard one, and
    a loud failure when the hard limit is too low (the fleet is never cut
    to fit)."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    check(hard == resource.RLIM_INFINITY or hard >= need,
          f"RLIMIT_NOFILE hard limit {hard} < the {need} descriptors "
          f"{FLEET} loopback connections need")
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return f"RLIMIT_NOFILE soft {soft} -> {hard}, hard {hard} (need {need})"


class FleetMiner:
    """One raw-wire stratum miner: a reader task resolves its requests'
    futures by id; notifications are read and dropped."""

    def __init__(self, index: int):
        self.worker = f"fleet.w{index:04d}"
        self.pending: dict = {}
        self.job = None
        self.extranonce1 = b""
        self.results: list = []     # (accepted, error, seconds)
        self.shares: list = []      # (extranonce2, nonce)

    async def connect(self, port: int, sp) -> None:
        self.reader, self.writer = await asyncio.open_connection("127.0.0.1",
                                                                 port)
        self.task = asyncio.get_running_loop().create_task(self._read(sp))
        self.next_id = 1
        sub = await self.call(sp, "mining.subscribe", ["fleet"])
        self.extranonce1 = bytes.fromhex(sub[1])
        ok = await self.call(sp, "mining.authorize", [self.worker, "x"])
        check(ok is True, f"{self.worker}: authorize refused")

    async def _read(self, sp) -> None:
        while True:
            line = await self.reader.readline()
            if not line:
                return
            msg = sp.decode_line(line)
            if msg.method == "mining.notify" and self.job is None:
                self.job = sp.job_from_notify(msg.params)
            elif msg.is_response:
                fut = self.pending.pop(msg.id, None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)

    async def call(self, sp, method, params):
        msg_id, self.next_id = self.next_id, self.next_id + 1
        fut = asyncio.get_running_loop().create_future()
        self.pending[msg_id] = fut
        self.writer.write(sp.encode_line(sp.Message(id=msg_id, method=method,
                                                    params=params)))
        msg = await asyncio.wait_for(fut, 30.0)
        if msg.error:
            raise sp.StratumError(*(list(msg.error) + [None] * 3)[:3])
        return msg.result

    async def submit(self, sp, en2: bytes, nonce: int) -> None:
        t0 = time.monotonic()
        params = [self.worker, self.job.job_id, en2.hex(),
                  f"{self.job.ntime:08x}", f"{nonce:08x}"]
        try:
            result = await self.call(sp, "mining.submit", params)
            self.results.append((result is True, None, time.monotonic() - t0))
        except sp.StratumError as e:
            self.results.append((False, e.as_triple(), time.monotonic() - t0))

    def close(self) -> None:
        self.task.cancel()
        self.writer.close()


def premine(miners, difficulty: float) -> int:
    """Each miner's shares on its job at ``difficulty``, on the host:
    extranonce2 = the share's index, the first winning nonce. Returns the
    hashes it took."""
    from otedama_tpu_torch.engine.jobs import build_header_prefix
    from otedama_tpu_torch.kernels import target as tgt

    target = tgt.difficulty_to_target(difficulty)
    hashes = 0
    for m in miners:
        job = dataclasses.replace(m.job, extranonce1=m.extranonce1)
        for j in range(FLEET_SHARES):
            en2 = struct.pack(">I", j)
            prefix = build_header_prefix(job, en2)
            nonce = 0
            while sha256d_value(prefix + struct.pack(">I", nonce)) > target:
                nonce += 1
            hashes += nonce + 1
            m.shares.append((en2, nonce))
    return hashes


def fleet_phase(dev, card: str, kernel_rate: float) -> int:
    """Phase 22: pool mode with local mining on B1 under a 1,000-miner
    fleet. Returns B1's launches in it."""
    import numpy as np

    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.stratum import protocol as sp

    phase(f"22 pool mode on the card: Application as `cli pool --mine` "
          f"sets it, B1 mining through its loopback client, {FLEET} "
          f"raw-wire miners x {FLEET_SHARES} shares over "
          f"{FLEET_WINDOW_S:.0f} s, difficulty-1 mock chain")
    limits = raise_fd_limit(2 * FLEET + 256)
    chain = MockChainClient(nbits=0x1D00FFFF)
    app = pool_app("sha256d", 1.0, chain, dev)
    card_latency, card_shares = [], []
    out: dict = {}

    async def run22():
        await app.start()
        try:
            booked = Booked(app.server, app.pool.on_share)
            submit = app.client.submit

            async def timed_submit(share):
                t_sent = time.monotonic()
                result = await submit(share)
                card_latency.append((t_sent, result.latency))
                card_shares.append((share, result.accepted))
                return result

            app.client.submit = timed_submit
            gate = Gate(app.engine)
            await engine_running(app)
            watch.start(app.engine)
            lift_ip_caps(app.server)
            miners = [FleetMiner(i) for i in range(FLEET)]
            t_ramp = time.monotonic()

            async def connect(i, m):
                await asyncio.sleep(i / FLEET_CONNECT_RATE)
                await m.connect(app.server.port, sp)

            await asyncio.gather(*(connect(i, m) for i, m in enumerate(miners)))
            ramp_s = time.monotonic() - t_ramp
            check(all(m.job is not None for m in miners),
                  "a fleet miner got no job")
            by_en1 = {s.extranonce1: s for s in app.server.sessions.values()}
            for m in miners:
                app.server._send_difficulty(by_en1[m.extranonce1],
                                            FLEET_DIFFICULTY)
            t_pre = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                premined = await asyncio.get_running_loop().run_in_executor(
                    pool, premine, miners, FLEET_DIFFICULTY)
            premine_s = time.monotonic() - t_pre
            rng = np.random.default_rng(SEED + 22)
            times = np.sort(rng.uniform(0, FLEET_WINDOW_S,
                                        size=FLEET * FLEET_SHARES))
            order = rng.permutation(FLEET * FLEET_SHARES)
            t0 = time.monotonic()

            async def fleet_submit(k, at):
                await asyncio.sleep(max(0.0, t0 + at - time.monotonic()))
                m = miners[k // FLEET_SHARES]
                await m.submit(sp, *m.shares[k % FLEET_SHARES])

            await asyncio.gather(*(fleet_submit(int(k), float(at))
                                   for k, at in zip(order, times)))
            t1 = time.monotonic()
            # a card block and its distribution; then the cut, after which
            # every share the card submitted has its verdict. The restart
            # lock keeps the supervisors from restarting the stopped
            # engine while the books are read
            await until(lambda: chain.submitted, MAIN_PATH_BOUND_S,
                        "a card block on the mock chain")
            await until(lambda: any(w["balance"] > 0
                                    for w in app.pool.workers.list()),
                        30.0, "distribute_block's credits")
            watch.stop()
            await gate.cut()
            async with app._restart_lock:
                await app.engine.stop()
                rows = app.db.query(
                    "SELECT worker, COUNT(*) AS c FROM shares GROUP BY worker")
                out.update(
                    booked=booked, miners=miners, ramp_s=ramp_s,
                    premine_s=premine_s, premined=premined, t0=t0, t1=t1,
                    held=gate.held, t_pre=t_pre,
                    rows={r["worker"]: r["c"] for r in rows},
                    snap=app.snapshot(), client=dict(app.client.stats),
                    balances=sum(w["balance"]
                                 for w in app.pool.workers.list()))
            for m in miners:
                m.close()
        finally:
            await app.stop()

    sc.launches.reset()
    st.calls.reset()
    watch = HashWatch()
    asyncio.run(run22())
    launches, plain = sc.launches.value, st.calls.value
    steady_rate, steady_text = watch.summary()
    # from 1 s into the submit window: the drained calls queued on the
    # card behind the pre-mine's stall catch up first, milliseconds apart
    window_rate, window_text = watch.between(out["t0"] + 1.0, out["t1"])
    check(launches > 0 and plain == 0,
          f"B1 launches {launches}, plain-version calls {plain}")
    miners, booked, snap = out["miners"], out["booked"], out["snap"]
    check({"stratum", "pool"} <= set(snap), "snapshot lacks stratum or pool")
    # three ways, per worker: the accepts the clients saw, the shares the
    # ledger hook took, the share rows in the database
    seen = {m.worker: sum(r[0] for r in m.results) for m in miners}
    seen[POOL_WORKER] = out["client"]["shares_accepted"]
    seen = {w: n for w, n in seen.items() if n}
    delivered = booked.by_worker()
    differ = sorted(w for w in set(seen) | set(delivered) | set(out["rows"])
                    if not seen.get(w) == delivered.get(w)
                    == out["rows"].get(w))
    check(not differ, "client accepts, on_share deliveries and db rows "
          f"disagree for {differ[:8]}")
    rejects = [r for m in miners for r in m.results if not r[0]]
    check(not rejects, f"{len(rejects)} honest fleet shares rejected: "
          f"{rejects[:4]}")
    check(sum(len(m.results) for m in miners) == FLEET * FLEET_SHARES
          and sum(seen[m.worker] for m in miners) == FLEET * FLEET_SHARES,
          "not every fleet share was accepted")
    check(out["client"]["shares_rejected"] == 0,
          f"{out['client']['shares_rejected']} card shares rejected")
    check_accepted(booked.shares)
    # every card share: the engine's digest is hashlib's of the header the
    # server rebuilt
    server_digest = {(s.job_id, s.extranonce2, s.nonce_word): s.digest
                     for s in booked.shares if s.worker_user == POOL_WORKER}
    for share, accepted in card_shares:
        key = (share.job_id, share.extranonce2, share.nonce_word)
        check(accepted and server_digest.get(key) == share.digest,
              f"card share {key} not booked with the engine's digest")
    target = tgt.bits_to_target(0x1D00FFFF)
    for height, header, block_hash in chain.submitted:
        check(sha256d_value(header) <= target, f"block {height} fails hashlib")
    check(chain.submitted and snap["pool"]["blocks"] >= 1
          and out["balances"] > 0, "no block credited by distribute_block")
    fleet_lat = [r[2] for m in miners for r in m.results]
    acc = snap["stratum"]["accept_latency"]
    card_n = seen.get(POOL_WORKER, 0)
    card_window = [lat for t, lat in card_latency
                   if out["t0"] <= t <= out["t1"]]
    print(f"   {limits}; {FLEET} connects in {out['ramp_s']:.2f} s; "
          f"{FLEET * FLEET_SHARES} shares pre-mined on the host in "
          f"{out['premine_s']:.2f} s ({out['premined']} hashes) at "
          f"difficulty {FLEET_DIFFICULTY:g}", flush=True)
    print(f"   accounting per worker equal three ways ({len(seen)} workers: "
          f"{FLEET} fleet, the card's {card_n} shares): client accepts = "
          f"on_share deliveries = db rows; every share re-hashed with "
          f"hashlib; fleet rejects 0, card rejects 0; {len(chain.submitted)} "
          f"card blocks on the mock chain, balances credited "
          f"{out['balances']}", flush=True)
    print(f"   share-accept latency: the server's histogram p50 "
          f"{acc['p50_ms']:.2f} ms, p99 {acc['p99_ms']:.2f} ms (bucket bounds,"
          f" {acc['count']} submits); the card's client in the submit window"
          f" {quantiles(card_window)}, over the phase "
          f"{quantiles([lat for _, lat in card_latency])}; the fleet's raw "
          f"clients {quantiles(fleet_lat)}; card shares held at the cut "
          f"{out['held']}", flush=True)
    print(f"   engine in the {out['t1'] - out['t0']:.2f} s submit window, "
          f"from its first second on: "
          f"{window_text} = {window_rate / kernel_rate:.1%} of phase 5's "
          f"kernel rate {kernel_rate / 1e9:.3f} GH/s; over the whole phase "
          f"({steady_rate / kernel_rate:.1%}), the pre-mine on a host thread "
          f"from {out['t_pre'] - watch.moves[0][0]:+.2f} s included: "
          f"{steady_text}; B1 launches {launches}, plain-version calls "
          f"{plain}; {card}", flush=True)
    return launches


class CountingCuda:
    """``CudaBackend`` with each read-back window recorded: the buffer's
    count word (the window's true winner count) beside the winners the
    backend found there, bisected or not, and the winners its host
    re-check dropped (it logs each as an error)."""

    @staticmethod
    def make(dev):
        from otedama_tpu_torch.kernels import sha256_cuda as sc
        from otedama_tpu_torch.runtime.search import CudaBackend

        class Counting(CudaBackend):
            windows: list = []

            def _found(self, jc, base, count, buf, k):
                n = int(sc.unpack_winner_buffer(buf, k)[2])
                words, min_hash = super()._found(jc, base, count, buf, k)
                self.windows.append((n, len(words), count))
                return words, min_hash

        # a fixed table of the default depth, so that windows at 1/64
        # overflow it and bisect (a table sized from the target would not)
        backend = Counting(dev, winner_depth=sc.K_WINNERS)
        backend.windows = []
        return backend


def vardiff_phase(dev, card: str) -> int:
    """Phase 23: a StratumServer at difficulty 1/64 with a fast vardiff,
    mined by B1 through a StratumClient. Returns B1's launches."""
    from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
    from otedama_tpu_torch.engine.vardiff import VardiffConfig
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.stratum import protocol as sp
    from otedama_tpu_torch.stratum.client import ClientConfig, StratumClient
    from otedama_tpu_torch.stratum.server import ServerConfig, StratumServer

    phase("23 low difficulty and vardiff on the card: StratumServer at "
          "difficulty 1/64, VardiffConfig(retarget_seconds=2, "
          "target_share_seconds=0.5), B1 through a StratumClient")
    vcfg = VardiffConfig(retarget_seconds=2.0, target_share_seconds=0.5)
    backend = CountingCuda.make(dev)
    engine = MiningEngine({backend.name: backend},
                          config=EngineConfig(worker_name="card.vardiff"))
    credited, retargets, jobs, verdicts = [], [], {}, []

    async def run23():
        server = StratumServer(ServerConfig(
            host="127.0.0.1", port=0, initial_difficulty=VARDIFF_START,
            vardiff=vcfg))

        async def on_share(s):
            session = server.sessions[s.session_id]
            credited.append((s, session.difficulty, session.prev_difficulty))

        server.on_share = on_share
        await server.start()
        client = None
        try:
            def on_difficulty(d):
                retargets.append((time.monotonic(), d))

            def on_job(job):
                jobs[job.job_id] = (time.monotonic(), job, client.difficulty)
                engine.set_job(job)

            client = StratumClient(
                ClientConfig(host="127.0.0.1", port=server.port,
                             username="card.vardiff"),
                on_job=on_job, on_difficulty=on_difficulty)

            async def submit(share):
                result = await client.submit(share)
                verdicts.append((share, result, client.difficulty))

            engine.on_share = submit
            await client.start()
            await asyncio.get_running_loop().run_in_executor(
                None, backend.precompile)
            await engine.start()
            for i in range(12):
                server.set_job(smoke_job(f"vd{i}", share_target=0), clean=True)
                await asyncio.sleep(1.0)
            await engine.stop()
        finally:
            await engine.close()
            if client is not None:
                await client.stop()
            await server.stop()

    sc.launches.reset()
    st.calls.reset()
    dropped = ErrorCount()
    logging.getLogger("otedama.runtime.search").addHandler(dropped)
    try:
        asyncio.run(run23())
    finally:
        logging.getLogger("otedama.runtime.search").removeHandler(dropped)
    launches, plain = sc.launches.value, st.calls.value
    check(launches > 0 and plain == 0,
          f"B1 launches {launches}, plain-version calls {plain}")
    windows = backend.windows
    over = [w for w in windows if w[0] > backend.k]
    check(over, "no launch overflowed its winner table at difficulty 1/64")
    check(all(n == got for n, got, _ in windows) and dropped.n == 0,
          "a window's count word differs from the winners returned: "
          f"{[w for w in windows if w[0] != w[1]][:4]}, {dropped.n} "
          "dropped by the host re-check")
    # the climb: at most x4 a retarget, and it climbs
    ds = [VARDIFF_START] + [d for _, d in retargets]
    check(len(ds) >= 3 and ds[-1] > VARDIFF_START, f"no climb: {ds}")
    check(all(b <= 4 * a * (1 + 1e-9) and b >= a / 4 * (1 - 1e-9)
              for a, b in zip(ds, ds[1:])), f"a step over x4: {ds}")
    # every retarget reaches the engine's next job
    job_times = sorted((t, job, d) for t, job, d in jobs.values())
    for t_r, d in retargets:
        nxt = [(t, job, dj) for t, job, dj in job_times if t > t_r]
        later = [t for t, _ in retargets if t > t_r]
        if nxt and (not later or nxt[0][0] < later[0]):
            check(nxt[0][1].share_target == tgt.difficulty_to_target(d),
                  f"retarget {d:g} did not reach the next job")
    # credits: at the difficulty in force when the share meets it, else at
    # the previous one (a share found under the previous target)
    prev_credits = 0
    job_d = {jid: dj for jid, (_, _, dj) in jobs.items()}
    for s, d_now, d_prev in credited:
        if tgt.hash_meets_target(s.digest, tgt.difficulty_to_target(d_now)):
            check(s.difficulty == d_now, f"share credited at {s.difficulty:g}"
                  f" though it meets the difficulty in force {d_now:g}")
        else:
            check(d_prev is not None and s.difficulty == d_prev
                  and job_d[s.job_id] <= d_prev * (1 + 1e-9),
                  f"share found under {job_d[s.job_id]:g} credited at "
                  f"{s.difficulty:g} (in force {d_now:g}, previous {d_prev})")
            prev_credits += 1
    check_accepted([c[0] for c in credited])
    rejected = [(sh, r, d) for sh, r, d in verdicts if not r.accepted]
    for sh, r, d_now in rejected:
        d_job = job_d[sh.job_id]
        check(r.error and r.error[0] == sp.ERR_LOW_DIFF and d_job < d_now
              and tgt.hash_meets_target(sh.digest,
                                        tgt.difficulty_to_target(d_job)),
              f"unexplained reject {r.error} of a share found under "
              f"{d_job:g} (difficulty then {d_now:g})")
    print(f"   {len(windows)} windows, {len(over)} overflowed and bisected "
          f"(count words up to {max(w[0] for w in windows)}), every window's "
          f"count word = the winners returned; difficulty "
          + " -> ".join(f"{d:.4g}" for d in ds)
          + f"; {len(credited)} shares credited, {prev_credits} of them at the"
          f" previous difficulty; {len(rejected)} low-difficulty rejects, each"
          f" of a share found under a difficulty two retargets old; B1 "
          f"launches {launches}; {card}", flush=True)
    return launches


def failover_phase(dev, card: str) -> int:
    """Phase 24: the app mining on B1 to the primary of two loopback
    upstreams; the primary stops. Returns B1's launches."""
    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig, UpstreamConfig
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.stratum.server import ServerConfig, StratumServer

    phase("24 upstream failover on the card: two loopback StratumServers as "
          "upstreams (priority 0 and 1), the primary stopped")
    accepted = {"primary": [], "backup": []}
    out: dict = {}

    async def run24():
        servers = {}
        for name in ("primary", "backup"):
            async def on_share(s, name=name):
                accepted[name].append((time.monotonic(), s))

            servers[name] = StratumServer(
                ServerConfig(host="127.0.0.1", port=0,
                             initial_difficulty=FAILOVER_DIFFICULTY,
                             session_secret="smoke-upstreams"),
                on_share=on_share)
            await servers[name].start()
        cfg = AppConfig()
        cfg.mining.device = str(dev)
        cfg.mining.worker_name = "card.up"
        cfg.upstreams = [UpstreamConfig(url=f"127.0.0.1:{servers[n].port}",
                                        username="card.up", priority=p)
                         for p, n in enumerate(("primary", "backup"))]
        app = Application(cfg)
        feed_stop = asyncio.Event()

        async def feed():
            i = 0
            while not feed_stop.is_set():
                job = smoke_job(f"up{i}", share_target=0)
                for s in servers.values():
                    s.set_job(job)
                i += 1
                await asyncio.sleep(1.0)

        feeder = asyncio.get_running_loop().create_task(feed())
        try:
            await app.start()
            await engine_running(app)
            # the watch sees the engine for 2 s before the stop and 2 s
            # after it: the window that the check below reads. Started
            # after the primary's third accept, it would see nothing
            # before the stop whenever app.start() outlasted one call
            watch = Timeline(app.engine)
            t_watch = time.monotonic()
            await until(lambda: len(accepted["primary"]) >= 3
                        and time.monotonic() >= t_watch + WATCH_SPAN_S,
                        MAIN_PATH_BOUND_S, "3 accepts at the primary")
            old = app.client
            en1 = old.extranonce1
            check(old.resume_token, "the primary issued no resume token")
            await servers["primary"].stop()
            t_stop = time.monotonic()
            checks = 0
            while app.failover.select() is not app.failover.pools[1]:
                await app.failover.check_all()
                checks += 1
                check(checks <= 10, "failover never selected the backup")
            t_sel = time.monotonic()
            await app._connect_upstream(app.failover.select())
            t_conn = time.monotonic()
            t_first = await until(lambda: accepted["backup"], 60.0,
                                  "an accept at the backup")
            await until(lambda: len(accepted["backup"]) >= 3
                        and time.monotonic() >= t_stop + WATCH_SPAN_S, 60.0,
                        "3 accepts at the backup")
            watch.stop()
            out.update(
                t_stop=t_stop, t_sel=t_sel, t_conn=t_conn,
                first=accepted["backup"][0][0], checks=checks, en1=en1,
                new_en1=app.client.extranonce1,
                resumes=servers["backup"].stats["resumes_accepted"],
                state=app.engine.state.value, moves=watch.moves,
                restarts=app.snapshot()["recovery"]["engine"]["restarts"],
                old_stopped=old not in app._started)
        finally:
            feed_stop.set()
            await feeder
            await app.stop()
            for s in servers.values():
                await s.stop()

    sc.launches.reset()
    st.calls.reset()
    asyncio.run(run24())
    launches, plain = sc.launches.value, st.calls.value
    check(launches > 0 and plain == 0,
          f"B1 launches {launches}, plain-version calls {plain}")
    check(out["resumes"] == 1 and out["new_en1"] == out["en1"],
          "the resume token did not carry the session to the backup "
          f"(resumes {out['resumes']}, en1 {out['en1'].hex()} -> "
          f"{out['new_en1'].hex()})")
    check(out["old_stopped"], "the old client is still in the app's books")
    check(out["state"] == "running" and out["restarts"] == 0,
          f"the engine stopped: state {out['state']}, restarts "
          f"{out['restarts']}")
    # the engine never stopped: its hash count kept moving, drained call
    # after drained call, from 2 s before the primary's stop to the end
    around = [t for t, _ in out["moves"]
              if t >= out["t_stop"] - WATCH_SPAN_S]
    gaps = [b - a for a, b in zip(around, around[1:])]
    after = sum(t > out["t_stop"] for t in around)
    check(len(around) >= 3 and after >= 1 and max(gaps) < 2.0,
          f"the engine's hash count stalled across the failover: "
          f"{len(around)} moves ({after} after the stop), gaps "
          f"{[round(g, 3) for g in gaps][:12]}")
    check_accepted([s for _, s in accepted["primary"] + accepted["backup"]])
    print(f"   primary stopped; {out['checks']} check_all rounds to select the"
          f" backup ({(out['t_sel'] - out['t_stop']) * 1e3:.1f} ms), "
          f"reconnected with the resume token in "
          f"{(out['t_conn'] - out['t_sel']) * 1e3:.1f} ms (extranonce1 "
          f"{out['en1'].hex()} kept); first accept at the backup "
          f"{(out['first'] - out['t_stop']) * 1e3:.1f} ms after the stop; the"
          f" engine's hash count moved {len(around)} times ({after} after the "
          f"stop) from 2 s before the stop to the end, the longest gap {max(gaps) * 1e3:.1f} ms, no"
          f" restart; accepts primary {len(accepted['primary'])}, backup "
          f"{len(accepted['backup'])}, every one re-hashed with hashlib; B1 "
          f"launches {launches}; {card}", flush=True)
    return launches


def scrypt_pool_phase(dev, card: str) -> int:
    """Phase 25: phase 22's app with ``mining.algorithm = "scrypt"`` on the
    ``romix`` tier. Returns B5's launches."""
    import torch

    import otedama_tpu_torch.stratum.server as server_mod
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import scrypt_torch as sct
    from otedama_tpu_torch.pool.blockchain import MockChainClient

    phase(f"25 a scrypt pool on the card: the pool app with "
          f"mining.algorithm=scrypt (romix tier, B5), share difficulty "
          f"2^-16, {SCRYPT_POOL_WINDOW_S:.0f} s")
    chain = MockChainClient(nbits=SCRYPT_NBITS)
    outcomes, digest_threads = [], []
    submit_block = chain.submit_block

    async def record_submit(header):
        outcome = await submit_block(header)
        outcomes.append(outcome)
        return outcome

    chain.submit_block = record_submit
    pow_digest = server_mod.pow_digest

    def traced_digest(header, algorithm="sha256d", block_number=0):
        digest_threads.append((algorithm, threading.current_thread().name))
        return pow_digest(header, algorithm, block_number)

    app = pool_app("scrypt", SCRYPT_POOL_DIFFICULTY, chain, dev)
    out: dict = {}

    async def run25():
        await app.start()
        try:
            booked = Booked(app.server, app.pool.on_share)
            gate = Gate(app.engine)
            await engine_running(app)
            watch.start(app.engine)
            h0, t0 = app.engine.stats.hashes, time.monotonic()
            await asyncio.sleep(SCRYPT_POOL_WINDOW_S)
            hashes, seconds = (app.engine.stats.hashes - h0,
                               time.monotonic() - t0)
            watch.stop()
            await gate.cut()
            async with app._restart_lock:
                await app.engine.stop()
            out.update(booked=booked, hashes=hashes, seconds=seconds,
                       held=gate.held,
                       client=dict(app.client.stats),
                       backend=next(iter(app.engine.backends.values())).name,
                       rows=app.db.query("SELECT COUNT(*) AS c FROM shares")[0]["c"])
        finally:
            await app.stop()

    for counter in (scc.romix_launches, scc.search_launches,
                    scc.blockmix_launches, scc.blockmix_xor_launches, sct.calls):
        counter.reset()
    server_mod.pow_digest = traced_digest
    watch = HashWatch()
    # every share is a block candidate that the mock chain refuses (it
    # checks blocks by sha256d): keep the submitter's warning per refusal
    # out of the log, they are counted below
    logging.getLogger("otedama.pool.submitter").setLevel(logging.ERROR)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        asyncio.run(run25())
    finally:
        server_mod.pow_digest = pow_digest
        logging.getLogger("otedama.pool.submitter").setLevel(logging.NOTSET)
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    romix, plain = scc.romix_launches.value, sct.calls.value
    check(romix > 0 and plain == 0,
          f"B5 launches {romix}, plain-version calls {plain}")
    check(scc.blockmix_launches.value == 0, "the romix tier ran BlockMix")
    shares = out["booked"].shares
    check(shares and len(shares) == out["rows"]
          == out["client"]["shares_accepted"], "scrypt accounting differs: "
          f"{len(shares)} booked, {out['rows']} rows, "
          f"{out['client']['shares_accepted']} client accepts")
    check(out["client"]["shares_rejected"] == 0, "a scrypt share rejected")
    check(all(s.algorithm == "scrypt" for s in shares), "non-scrypt share")
    scrypt_digests = [t for a, t in digest_threads if a == "scrypt"]
    check(len(scrypt_digests) == out["client"]["shares_submitted"]
          and all(t.startswith("share-validate") for t in scrypt_digests),
          "a scrypt share was not digested on the validation executor: "
          f"{sorted(set(scrypt_digests))}")
    check_accepted(shares)
    refused: dict = {}
    for o in outcomes:
        if not o.accepted:
            refused[o.reason] = refused.get(o.reason, 0) + 1
    print(f"   backend {out['backend']}: {out['hashes']} hashes in "
          f"{out['seconds']:.2f} s = {out['hashes'] / out['seconds']:.1f} H/s;"
          f" {watch.summary()[1]};"
          f" {len(shares)} shares booked ({out['held']} held at the cut) = db rows = client accepts, each "
          f"digested by hashlib.scrypt on the validation executor "
          f"({sorted(set(scrypt_digests))}) and re-hashed here; block "
          f"candidates {len(outcomes)}: accepted "
          f"{sum(o.accepted for o in outcomes)}, refused {refused} (the mock "
          f"chain checks blocks by sha256d); V's peak device memory "
          f"{peak / 2**30:.2f} GiB; B5 launches {romix}, search launches "
          f"{scc.search_launches.value}, plain-version calls {plain}; {card}",
          flush=True)
    return romix


def pool_phases(dev, card: str, kernel_rate: float) -> dict:
    """Phases 22-25. Returns B1's and B5's launches in them."""
    return dict(fleet=fleet_phase(dev, card, kernel_rate),
                vardiff=vardiff_phase(dev, card),
                failover=failover_phase(dev, card),
                b5=scrypt_pool_phase(dev, card))


# -- phases 26-27: the P2P share-chain pool on the card --------------------------

P2P_SEEDS = 16            # the reference's sharechain bench: config.nodes (r09)
P2P_WORKERS = 256
P2P_CHAIN = 10_000        # one PPLNS window (8,192) and 1,808 more
# about 43 host hashes a share: the overlay grinds 10,000 shares, then a
# batch of 500 a second; difficulty_to_target keeps it a compact target
P2P_DIFFICULTY = 1e-8
P2P_BATCH = 500           # MAX_SHARE_BATCH: one SHARE_BATCH flood a second
P2P_GOSSIP_S = 10.0
P2P_FORGE_EVERY = 256     # one share in 256 forged
P2P_IDLE_S = 2.0          # the window with the engine stopped
P2P_IDLE_BATCH = 200      # a sync page's size, one flood each 0.1 s in it
SCRYPT_P2P_CHAIN = 1_200
# a target near 2^255: hashlib.scrypt grinds a share in one or two tries
SCRYPT_P2P_DIFFICULTY = 2.0 ** -31


def load_pg_emulator():
    """``tests/pg_emulator.py`` (a PostgreSQL v3 wire-protocol server over
    SQLite, threads on loopback), loaded by path, with TCP_NODELAY on its
    accepted sockets as a PostgreSQL backend sets it: the emulator writes
    CommandComplete and ReadyForQuery apart, and Nagle would hold the
    second behind the client's delayed ACK (~40 ms a statement)."""
    import importlib.util
    import socket

    path = os.path.join(ROOT, "tests", "pg_emulator.py")
    check(os.path.exists(path), f"{path} is missing: the PostgreSQL phases "
          "need the repository's tests/pg_emulator.py")
    spec = importlib.util.spec_from_file_location("otedama_pg_emulator", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Emulator(mod.PgEmulator):
        def _serve(self, sock):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            super()._serve(sock)

    return Emulator


def p2p_app(dev, algorithm: str, difficulty: float, dsn: str, chain,
            bootstrap: list, mine: bool, chain_dir: str = ""):
    """An ``Application`` configured as ``cli p2p [--mine]`` sets it (p2p
    and pool on), with validation at its defaults on the card, the books
    in PostgreSQL at ``dsn``, phase 22's stratum and mock-chain settings,
    and the node bootstrapping to ``bootstrap`` on loopback. With
    ``chain_dir`` the chain is durable there (the store's other knobs at
    their defaults) and the API is on at a loopback port of its own."""
    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig, validate_config

    cfg = AppConfig()
    cfg.p2p.enabled = True
    cfg.pool.enabled = True
    cfg.mining.enabled = mine
    cfg.mining.device = str(dev)
    cfg.mining.algorithm = algorithm
    cfg.mining.worker_name = POOL_WORKER
    cfg.validation.enabled = True
    cfg.pool.database = dsn
    cfg.stratum.enabled = True
    cfg.stratum.host = "127.0.0.1"
    cfg.stratum.port = 0
    cfg.stratum.initial_difficulty = 1.0
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.5
    cfg.p2p.host = "127.0.0.1"
    cfg.p2p.port = 0
    cfg.p2p.share_difficulty = difficulty
    cfg.p2p.bootstrap = [f"127.0.0.1:{port}" for port in bootstrap]
    if chain_dir:
        cfg.p2p.chain_dir = chain_dir
        cfg.api.enabled = True
        cfg.api.host = "127.0.0.1"
        cfg.api.port = 0
    errors = validate_config(cfg)
    check(not errors, f"p2p config refused: {errors}")
    return Application(cfg, chain=chain)


def compact_round_trip(difficulty: float) -> int:
    """The share target a chain at ``difficulty`` claims, checked to be a
    valid compact target that meets the chain's floor."""
    from otedama_tpu_torch.kernels import target as tgt

    exact = tgt.difficulty_to_target(difficulty)
    claimed = tgt.bits_to_target(tgt.target_to_bits(exact))
    check(0 < claimed <= exact < 1 << 256
          and claimed >= exact - (exact >> 15),
          f"difficulty {difficulty:g}: compact target {claimed:#x} for "
          f"{exact:#x}")
    return claimed


class VerifyLog:
    """The validator's ``verify_batch``, each call recorded: its start, its
    time, its checks and verdicts, and whether the engine was mining."""

    def __init__(self, validator, engine):
        self.calls, self.engine = [], engine
        self.verify = validator.verify_batch
        validator.verify_batch = self

    async def __call__(self, checks):
        mining = (self.engine is not None
                  and self.engine.state.value == "running")
        t0 = time.monotonic()
        verdicts = await self.verify(checks)
        self.calls.append((t0, time.monotonic() - t0, list(checks),
                           list(verdicts), mining))
        return verdicts


def sha256d_id(header: bytes) -> bytes:
    """A share's id: sha256d of its header, whatever its algorithm."""
    return hashlib.sha256(hashlib.sha256(header).digest()).digest()


class GcWatch:
    """The cyclic garbage collector's passes while a ``with`` block runs
    (``gc.callbacks``): each pass's generation and pause. A full pass
    stops every thread of the process for as long as it walks the heap."""

    def __init__(self):
        self.passes: list[tuple[int, float]] = []
        self._t0 = 0.0

    def _callback(self, stage, info):
        if stage == "start":
            self._t0 = time.perf_counter()
        else:
            self.passes.append((info["generation"],
                                time.perf_counter() - self._t0))

    def __enter__(self) -> "GcWatch":
        self.tracked = len(gc.get_objects())
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._callback)

    def summary(self) -> str:
        rows = []
        for g in (0, 1, 2):
            pauses = [p for gen, p in self.passes if gen == g]
            if pauses:
                rows.append(f"gen {g}: {len(pauses)} passes, "
                            f"{sum(pauses) * 1e3:.1f} ms in all, max "
                            f"{max(pauses) * 1e3:.1f} ms")
        return (f"the garbage collector over {self.tracked} tracked objects: "
                + ("; ".join(rows) or "no pass"))


class LoopLag:
    """How late the event loop wakes a 10 ms sleep: each sample's start
    and its lateness, for the share of the loop other work holds."""

    def __init__(self):
        self.samples, self._task = [], None

    async def _poll(self):
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(0.01)
            self.samples.append((t0, time.monotonic() - t0 - 0.01))

    def start(self):
        self._task = asyncio.get_running_loop().create_task(self._poll())

    def stop(self):
        self._task.cancel()

    def between(self, t0: float, t1: float) -> str:
        return quantiles([lag for t, lag in self.samples if t0 <= t <= t1])


def hashlib_verdict(check_) -> bool:
    value = (scrypt_value(check_.header) if check_.algorithm == "scrypt"
             else sha256d_value(check_.header))
    return value <= check_.target


def forge(sc, share):
    """``tests/test_validation.py``'s forgery: a nonce byte flipped after
    grinding, the claim untouched. At an easy share target a flipped
    nonce can still meet it (about one in 43 at 1e-8), so the flip is
    the first of 0xFF, 0xFE, ... whose digest fails hashlib's check."""
    for mask in range(0xFF, 0, -1):
        raw = bytearray(share.header)
        raw[76] ^= mask
        if sha256d_value(bytes(raw)) > share.target:
            return sc.Share.from_payload({**share.to_payload(),
                                          "header": bytes(raw).hex()})
    raise SmokeFailure("no nonce byte flip forges the share")


def grind(sc, prev: bytes, first: int, count: int, difficulty: float,
          algorithm: str = "sha256d", forge_every: int = 0):
    """``count`` shares of one lineage from ``prev`` (workers in turn),
    each ``forge_every``-th ground off the tip without advancing it and
    then forged. Returns (shares in order, the forged ids)."""
    claims = [(f"p2p.w{(first + i) % P2P_WORKERS:03d}", f"job{first + i}")
              for i in range(count)]
    forged_at = {i for i in range(count)
                 if forge_every and (first + i) % forge_every == forge_every - 1}
    shares = sc.mine_share_chain(prev, claims, difficulty, algorithm=algorithm,
                                 advance=[i not in forged_at
                                          for i in range(count)])
    for i in forged_at:
        shares[i] = forge(sc, shares[i])
    return shares, {shares[i].share_id for i in forged_at}


async def seed_overlay(sc, params, lineage, n: int):
    """``n`` of the port's ``P2PPool``s on loopback TCP, no validator, each
    chain preloaded with ``lineage`` by ``ShareChain.connect``, linked as
    a ring with shortcuts (p2p/memnet.py's topology)."""
    from otedama_tpu_torch.p2p.memnet import ring_with_shortcuts
    from otedama_tpu_torch.p2p.node import NodeConfig
    from otedama_tpu_torch.p2p.pool import P2PPool

    seeds = [P2PPool(NodeConfig(host="127.0.0.1", port=0, max_peers=64),
                     params) for _ in range(n)]
    for seed in seeds:
        for share in lineage:
            check(seed.chain.connect(share) == "accepted", "preload refused")
        await seed.start()
    edges = ring_with_shortcuts(n, shortcuts_per_node=2) if n > 1 else []
    for a, b in edges:
        await seeds[a].node.connect("127.0.0.1", seeds[b].node.port)
    await until(lambda: all(len(s.node.peers) == sum(i in e for e in edges)
                            for i, s in enumerate(seeds)),
                30.0, "the overlay's links")
    return seeds, edges


def overlay_process(conn, n: int, length: int, difficulty: float,
                    algorithm: str) -> None:
    """The overlay the app joins, in a process of its own (a deployment's
    peers are other machines): ``n`` seeds holding one lineage of
    ``length`` shares. Serves the phase's requests over ``conn``:
    ("flood", (count, forge_every)) has seed 0 grind ``count`` shares on
    its tip and flood them as one SHARE_BATCH; ("state", forged ids)
    reads every seed; ("stop", None) ends it."""
    logging.getLogger("otedama.p2p.pool").setLevel(logging.ERROR)
    try:
        asyncio.run(_overlay_serve(conn, n, length, difficulty, algorithm))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


async def _overlay_serve(conn, n, length, difficulty, algorithm):
    from otedama_tpu_torch.p2p import sharechain as sc
    from otedama_tpu_torch.p2p.messages import MessageType, P2PMessage

    loop = asyncio.get_running_loop()
    t0 = time.monotonic()
    lineage, _ = grind(sc, sc.GENESIS, 0, length, difficulty, algorithm)
    grind_s = time.monotonic() - t0
    t0 = time.monotonic()
    params = sc.ChainParams(algorithm=algorithm, min_difficulty=difficulty)
    seeds, edges = await seed_overlay(sc, params, lineage, n)
    origin, first = seeds[0], length
    tries = sum(int.from_bytes(s.header[76:80], "big") + 1 for s in lineage)
    conn.send(("ready", dict(ports=[s.node.port for s in seeds], edges=edges,
                             grind_s=grind_s, tries=tries,
                             overlay_s=time.monotonic() - t0)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        while True:
            cmd, arg = await loop.run_in_executor(None, conn.recv)
            if cmd == "flood":
                count, forge_every = arg
                batch, bad = await loop.run_in_executor(
                    pool, grind, sc, origin.chain.tip, first, count,
                    difficulty, algorithm, forge_every)
                first += count
                for s in batch:
                    if s.share_id not in bad:
                        check(origin.chain.connect(s) == "accepted",
                              "the origin refused its own share")
                await origin.node.broadcast(P2PMessage(
                    MessageType.SHARE_BATCH,
                    {"shares": [s.to_payload() for s in batch]}))
                conn.send(("flooded", sorted(bad)))
            elif cmd == "state":
                conn.send(("state", dict(
                    tips=[(s.chain.tip, s.chain.height) for s in seeds],
                    weights=[s.weights() for s in seeds],
                    pow=[s.rejects.get("pow", 0) for s in seeds],
                    linked=[any(f in s.chain for f in arg) for s in seeds],
                    shares=first)))
            else:
                for s in seeds:
                    await s.stop()
                conn.send(("stopped", None))
                return


class Child:
    """A process of the phase's own (multiprocessing spawn), spoken to
    over a pipe: each command gets one named reply."""

    def __init__(self, name: str, target, *args):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.name = name
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=target, daemon=True,
                                args=(child, *args))
        self.proc.start()

    def _reply(self, want: str, timeout: float = 60.0):
        check(self.conn.poll(timeout), f"the {self.name} gave no {want}")
        kind, value = self.conn.recv()
        check(kind == want, f"the {self.name}: {kind}: {value}")
        return value

    async def ask(self, cmd: str, arg, want: str, timeout: float = 60.0):
        self.conn.send((cmd, arg))
        return await self.reply(want, timeout)

    async def reply(self, want: str, timeout: float = 60.0):
        return await asyncio.get_running_loop().run_in_executor(
            None, self._reply, want, timeout)

    def close(self) -> None:
        self.proc.join(30.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()


class Overlay(Child):
    """The phase's end of ``overlay_process``."""

    def __init__(self, n: int, length: int, difficulty: float,
                 algorithm: str = "sha256d"):
        super().__init__("overlay process", overlay_process, n, length,
                         difficulty, algorithm)
        self.info = self._reply("ready", 300.0)

    async def call(self, cmd: str, arg=None, timeout: float = 60.0):
        reply = {"flood": "flooded", "state": "state", "stop": "stopped"}[cmd]
        return await self.ask(cmd, arg, reply, timeout)


def b2_beside(dev, words, limbs) -> str:
    """When a B2 call on one stream is done if it is launched 50 ms into
    another stream's kernel: a 2^31-nonce B1 launch (B2 on a stream of
    normal and of the highest priority), and a one-block spin of the
    same length. Launches here are outside every counted window."""
    import torch

    from otedama_tpu_torch.kernels import sha256_cuda as sc_k

    a = torch.cuda.Stream(dev)
    low, high = torch.cuda.Stream(dev), torch.cuda.Stream(
        dev, priority=torch.cuda.Stream.priority_range()[1])
    jw = sc_k.pack_job_words([0] * 8, [0] * 3, 0, [0] * 8)
    out_a = torch.empty(sc_k.winner_buffer_words(16), dtype=torch.int32,
                        device=dev)
    out_b = torch.empty_like(out_a)
    n = len(words)
    sc_k.sha256d_verify(words, limbs, n, stream=low, out=out_b)
    with torch.cuda.stream(a):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        e0.record(a)
        torch.cuda._sleep(1 << 26)
        e1.record(a)
    e1.synchronize()
    cycles = int((1 << 26) * 289.0 / e0.elapsed_time(e1))
    rows = []
    for name, other, stream in (
            ("B1", lambda: sc_k.sha256d_search(jw, batch=MAIN_BATCH, device=dev,
                                               stream=a, out=out_a), low),
            ("B1, B2 at the highest priority", lambda: sc_k.sha256d_search(
                jw, batch=MAIN_BATCH, device=dev, stream=a, out=out_a), high),
            ("a one-block spin", lambda: torch.cuda._sleep(cycles), low)):
        waits = []
        for _ in range(3):
            with torch.cuda.stream(a):
                other()
            done_a = torch.cuda.Event()
            done_a.record(a)
            time.sleep(0.05)
            t0 = time.monotonic()
            sc_k.sha256d_verify(words, limbs, n, stream=stream, out=out_b)
            done_b = torch.cuda.Event()
            done_b.record(stream)
            while not done_b.query():
                pass
            waits.append((time.monotonic() - t0) * 1e3)
            done_a.synchronize()
        rows.append(f"beside {name} " + ", ".join(f"{w:.2f}" for w in waits))
    return "; ".join(rows)


def b1_now(dev) -> float:
    """B1's rate (H/s) on the card as it is now: as phase 5 times it,
    the median of 3 rounds of 2 back-to-back 2^31-nonce launches after a
    warm-up launch, on a stream of its own (7 launches, outside every
    counted window: callers take them off their counts)."""
    import torch

    from otedama_tpu_torch.kernels import sha256_cuda as sc_k

    jw = sc_k.pack_job_words([0] * 8, [0] * 3, 0, [0] * 8)
    stream = torch.cuda.Stream(dev)
    out = torch.empty(sc_k.winner_buffer_words(sc_k.K_WINNERS),
                      dtype=torch.int32, device=dev)
    ms, _ = median_ms(lambda: sc_k.sha256d_search(
        jw, batch=MAIN_BATCH, device=dev, stream=stream, out=out), stream, 2)
    return MAIN_BATCH / ms * 1e3


def b2_against_plain(dev, pairs) -> int:
    """B2 and its plain version on one batch of (header, target) pairs as a
    path gave them (launches outside every counted window): the max
    absolute difference of their ``uint32[2k+3]`` buffers, which must be
    0. Returns the number of failures in the batch."""
    import numpy as np
    import torch

    from otedama_tpu_torch.kernels import sha256_cuda as sc_k
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt

    k = sc_k.K_WINNERS
    words = torch.from_numpy(st.headers_to_words(
        [h for h, _ in pairs]).view(np.int32)).to(dev)
    limbs = torch.from_numpy(np.stack([tgt.target_to_limbs(t)
                                       for _, t in pairs]).view(np.int32)).to(dev)
    a = sc_k.sha256d_verify(words, limbs, len(pairs), k=k).cpu().numpy()
    b = st.sha256d_verify_step(words, limbs, len(pairs) - 1, k=k).cpu().numpy()
    err = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
    check(err == 0, f"B2 != plain on a batch of {len(pairs)}")
    return int(b.view(np.uint32)[2 * k])


def p2p_phase(dev, card: str, kernel_rate: float) -> dict:
    """Phase 26: ``cli p2p --mine`` on the card with PostgreSQL books.
    Returns B1's and B2's launches and B2's max_abs_err at the path's
    shapes."""
    import numpy as np
    import torch

    from otedama_tpu_torch.kernels import sha256_cuda as sc_k
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.kernels.card import Sampler
    from otedama_tpu_torch.pool.blockchain import MockChainClient

    phase(f"26 `cli p2p --mine` on the card: catch-up of {P2P_CHAIN} shares "
          f"from {P2P_SEEDS} loopback nodes, {P2P_GOSSIP_S:.0f} s of "
          f"SHARE_BATCH gossip verified by B2, B1 mining for its stratum "
          f"pool, the books in PostgreSQL (tests/pg_emulator.py)")
    claimed = compact_round_trip(P2P_DIFFICULTY)
    chain = MockChainClient(nbits=0x1D00FFFF)
    Emulator = load_pg_emulator()
    overlay = Overlay(P2P_SEEDS, P2P_CHAIN, P2P_DIFFICULTY)
    info = overlay.info
    out: dict = {}

    async def run26(emu):
        app = p2p_app(dev, "sha256d", P2P_DIFFICULTY, emu.dsn, chain,
                      info["ports"], mine=True)
        try:
            await app.start()
            check(app.p2p.validator is app.validator is not None,
                  "the validator is not on the gossip path")
            check(type(app.db).__name__ == "PostgresDatabase"
                  and app.db._kind == "pgwire",
                  f"books on {type(app.db).__name__}")
            booked = Booked(app.server, app.pool.on_share)
            gate = Gate(app.engine)
            vlog = VerifyLog(app.validator, app.engine)
            await until(lambda: len(app.p2p.node.peers) == P2P_SEEDS, 30.0,
                        "the app's links to the overlay")
            await engine_running(app)
            watch.start(app.engine)
            lag.start()
            # catch-up: locator sync from every peer, page by page
            t_sync = time.monotonic()
            await app.p2p.request_sync()
            await until(lambda: app.p2p.chain.height == P2P_CHAIN, 120.0,
                        "the catch-up")
            out["catchup_s"] = time.monotonic() - t_sync
            out["catchup_calls"] = len(vlog.calls)
            # gossip: a batch of 500 a second from seed 0, relayed by the
            # others; one share in 256 forged
            forged: set = set()
            with Sampler(period=1.0) as sampled, GcWatch() as collected:
                t_g0 = time.monotonic()
                for k in range(int(P2P_GOSSIP_S)):
                    await asyncio.sleep(max(0.0, t_g0 + k - time.monotonic()))
                    forged |= set(await overlay.call(
                        "flood", (P2P_BATCH, P2P_FORGE_EVERY)))
                t_g1 = t_g0 + P2P_GOSSIP_S
                await asyncio.sleep(max(0.0, t_g1 - time.monotonic()))
            out["card"], out["gc"] = sampled.summary(), collected.summary()
            height = P2P_CHAIN + int(P2P_GOSSIP_S) * P2P_BATCH - len(forged)
            await until(lambda: app.p2p.chain.height == height, 60.0,
                        "the app at the gossip's height")
            watch.stop()
            out["gossip_calls"] = len(vlog.calls)
            # the engine stopped: the books, then page-sized batches for
            # P2P_IDLE_S, then the overlay's convergence. The restart lock
            # keeps the supervisors from restarting it meanwhile
            await gate.cut()
            async with app._restart_lock:
                await app.engine.stop()
                # the engine is stopped: B1's launches here are b1_now's
                before = sc_k.launches.value
                out["b1_now"] = await asyncio.get_running_loop(
                ).run_in_executor(None, b1_now, dev)
                timing_launches = sc_k.launches.value - before
                rows = app.db.query("SELECT worker, COUNT(*) AS c "
                                    "FROM shares GROUP BY worker")
                out["rows"] = {r["worker"]: r["c"] for r in rows}
                out["client"] = dict(app.client.stats)
                tq = time.monotonic()
                app.db.query("SELECT COUNT(*) AS c FROM shares")
                out["pg_round_trip_s"] = time.monotonic() - tq
                t_i0 = time.monotonic()
                k = 0
                while time.monotonic() < t_i0 + P2P_IDLE_S:
                    await asyncio.sleep(max(0.0, t_i0 + 0.1 * k
                                            - time.monotonic()))
                    await overlay.call("flood", (P2P_IDLE_BATCH, 0))
                    k += 1
                height += k * P2P_IDLE_BATCH
                await until(lambda: app.p2p.chain.height == height, 60.0,
                            "the app at the idle window's height")
                t_c = time.monotonic()
                while True:
                    state = await overlay.call("state", sorted(forged))
                    if set(state["tips"]) == {(app.p2p.chain.tip, height)}:
                        break
                    check(time.monotonic() < t_c + 120.0,
                          f"the overlay's tips: {set(state['tips'])}")
                    await asyncio.sleep(0.5)
            lag.stop()
            out.update(
                t_sync=t_sync, t_i0=t_i0, t_c=t_c,
                failures=app.failure_detector.snapshot(),
                recovery=app.recovery.snapshot(),
                t_g0=t_g0, t_g1=t_g1, forged=forged, booked=booked,
                vlog=vlog, held=gate.held, state=state, height=height,
                relay_s=time.monotonic() - t_c,
                weights=app.p2p.weights(), full=app.p2p.chain.weights_full(),
                app_linked=any(f in app.p2p.chain for f in forged),
                p2p=app.p2p.snapshot(), stats=dict(app.validator.stats),
                b2=sc_k.verify_launches.value,
                b1=sc_k.launches.value - timing_launches,
                plain=st.calls.value)
        finally:
            await app.stop()
            await overlay.call("stop")

    sc_k.launches.reset()
    sc_k.verify_launches.reset()
    st.calls.reset()
    watch, lag = HashWatch(), LoopLag()
    # each node logs each forged share it rejects: counted below instead
    logging.getLogger("otedama.p2p.pool").setLevel(logging.ERROR)
    try:
        with Emulator() as emu:
            t_run = time.monotonic()
            asyncio.run(run26(emu))
            run_s = time.monotonic() - t_run
    finally:
        logging.getLogger("otedama.p2p.pool").setLevel(logging.NOTSET)
        overlay.close()
    vlog, snap, stats, forged = out["vlog"], out["p2p"], out["stats"], out["forged"]
    state = out["state"]
    # the chain: every node on one tip, the weights exact and equal
    check(out["weights"] == out["full"] and all(
        w == out["weights"] for w in state["weights"]),
          "weights() != weights_full() or the seeds' weights")
    check(state["shares"] == out["height"] + len(forged),
          f"{state['shares']} shares flooded, height {out['height']}, "
          f"{len(forged)} forged")
    # the verdicts: every one equals hashlib's; the forged shares failed
    # PoW, were never linked and never relayed by an honest node
    sizes, wrong, failed = [], 0, set()
    for _, _, checks, verdicts, _ in vlog.calls:
        sizes.append(len(checks))
        for c, v in zip(checks, verdicts):
            wrong += v != hashlib_verdict(c)
            if not v:
                failed.add(sha256d_id(c.header))
    check(wrong == 0, f"{wrong} verdicts differ from hashlib's")
    # a forged share whose batchmates a node already holds arrives alone
    # and takes the per-share host path, around the validator
    check(failed <= forged and snap["rejects"] == {"pow": len(forged)},
          f"rejects {snap['rejects']}, failed verdicts {len(failed)}, forged "
          f"{len(forged)}")
    check(not out["app_linked"] and not any(state["linked"]),
          "a forged share was linked")
    origin_peers = {i for e in info["edges"] if 0 in e for i in e} - {0}
    check(all(n == (len(forged) if i in origin_peers else 0)
              for i, n in enumerate(state["pow"])),
          f"forged shares relayed: pow rejects by node {state['pow']}, the "
          f"origin's neighbours {sorted(origin_peers)}")
    # the kernels: B2 once a device batch, each at least min_batch shares
    device = [n for n in sizes if n >= 128]
    check(out["b2"] == stats["device_batches"] == len(device) > 0
          and stats["validated_device"] == sum(device),
          f"B2 launches {out['b2']}, device batches {stats['device_batches']}"
          f", calls of >= 128 shares {len(device)}")
    check(snap["verify_failures"] == 0 and stats["device_errors"] == 0
          and stats["tripwire_mismatches"] == 0 and stats["overflows"] == 0,
          f"rails: verify failures {snap['verify_failures']}, device errors "
          f"{stats['device_errors']}, tripwire mismatches "
          f"{stats['tripwire_mismatches']}, overflows {stats['overflows']}")
    check(out["b1"] > 0 and out["plain"] == 0,
          f"B1 launches {out['b1']}, plain-version calls {out['plain']}")
    # the books, three ways: the card's client accepts, the ledger hook's
    # deliveries, the share rows read back over pgwire
    seen = out["client"]["shares_accepted"]
    delivered = out["booked"].by_worker().get(POOL_WORKER, 0)
    check(seen > 0 and seen == delivered == out["rows"].get(POOL_WORKER)
          and set(out["rows"]) == {POOL_WORKER}
          and out["client"]["shares_rejected"] == 0,
          f"books: client {seen}, on_share {delivered}, rows {out['rows']}")
    check_accepted(out["booked"].shares)
    check(chain.submitted, "no card block on the mock chain")
    # B2 against its plain version at the path's shapes: a catch-up page
    # and a gossip batch with its forged shares (not counted above)
    for name, (_, _, checks, _, _) in (
            ("a sync page", vlog.calls[out["catchup_calls"] - 1]),
            ("a gossip batch", max(vlog.calls[out["catchup_calls"]:
                                              out["gossip_calls"]],
                                   key=lambda c: len(c[2])))):
        failures = b2_against_plain(dev, [(c.header, c.target)
                                          for c in checks])
        print(f"   B2 vs plain version on {name} ({len(checks)} shares, "
              f"{failures} failures): equal", flush=True)
    _, _, checks, _, _ = vlog.calls[out["catchup_calls"] - 1]
    words = torch.from_numpy(st.headers_to_words(
        [c.header for c in checks]).view(np.int32)).to(dev)
    limbs = torch.from_numpy(np.stack([tgt.target_to_limbs(c.target)
                                       for c in checks]).view(np.int32)).to(dev)
    beside = b2_beside(dev, words, limbs)
    rate, rate_text = watch.between(out["t_g0"], out["t_g1"])
    catch = [c[1] for c in vlog.calls[:out["catchup_calls"]] if c[4]]
    gossip = [c[1] for c in vlog.calls[out["catchup_calls"]:out["gossip_calls"]]
              if c[4]]
    idle = [c[1] for c in vlog.calls[out["gossip_calls"]:] if not c[4]]
    print(f"   the overlay's process: {P2P_CHAIN} shares ground on the host in "
          f"{info['grind_s']:.2f} s (difficulty {P2P_DIFFICULTY:g}, target "
          f"{claimed:#x}, {info['tries']} hashes); {P2P_SEEDS} nodes "
          f"preloaded and linked ({len(info['edges'])} links) in "
          f"{info['overlay_s']:.2f} s", flush=True)
    print(f"   catch-up: {P2P_CHAIN} shares in {out['catchup_s']:.3f} s = "
          f"{P2P_CHAIN / out['catchup_s']:.0f} shares/s, "
          f"{snap['sync_pages_received']} sync pages received, "
          f"{out['catchup_calls']} verify_batch calls; every node at height "
          f"{out['height']}, one tip (the overlay {out['relay_s']:.2f} s "
          f"after the app); weights() = weights_full() = the seeds' "
          f"({len(out['weights'])} workers)", flush=True)
    print(f"   verify_batch latency: catch-up pages with B1 mining "
          f"{quantiles(catch)}; gossip batches of {P2P_BATCH} with B1 mining "
          f"{quantiles(gossip)}; batches of {P2P_IDLE_BATCH} over "
          f"{P2P_IDLE_S:.0f} s with the engine stopped {quantiles(idle)}; "
          f"B2 on a page, ms from its launch to done, launched 50 ms into "
          f"another stream's kernel: {beside}", flush=True)
    print(f"   verdicts: {sum(sizes)} shares in {len(sizes)} calls, every one "
          f"= hashlib's; {len(forged)} forged ({len(failed)} failed in "
          f"verify_batch, the rest alone on the per-share host path): pow "
          f"rejects {snap['rejects']}, none linked, none relayed (pow "
          f"rejects by node {state['pow']}); B2 launches {out['b2']} = "
          f"device batches (sizes {min(device)}-{max(device)}); host batches "
          f"{stats['host_batches']}; verify failures, device errors, tripwire "
          f"mismatches 0 ({stats['tripwire_checks']} tripwire checks)",
          flush=True)
    print(f"   books in PostgreSQL (the emulator: its rates are no measure of "
          f"PostgreSQL): client accepts {seen} = on_share {delivered} = rows "
          f"{out['rows'].get(POOL_WORKER, 0)} ({out['held']} held at the cut); "
          f"{len(chain.submitted)} card blocks; a query's round trip "
          f"{out['pg_round_trip_s'] * 1e3:.2f} ms", flush=True)
    print(f"   the app's event loop, lateness of a 10 ms sleep: catch-up "
          f"{lag.between(out['t_sync'], out['t_g0'])}; gossip "
          f"{lag.between(out['t_g0'], out['t_g1'])}; engine stopped "
          f"{lag.between(out['t_i0'], out['t_c'])}; failure detector "
          f"{out['failures']}; recovery {out['recovery']}", flush=True)
    print(f"   engine over the {P2P_GOSSIP_S:.0f} s gossip window: {rate_text} "
          f"= {rate / kernel_rate:.1%} of phase 5's kernel rate "
          f"{kernel_rate / 1e9:.3f} GH/s; the card over the window "
          f"{out['card']}; {out['gc']}; B1 right after it "
          f"{out['b1_now'] / 1e9:.3f} GH/s "
          f"({out['b1_now'] / kernel_rate:.1%} of phase 5's; the engine "
          f"{rate / out['b1_now']:.1%} of it); B1 launches {out['b1']}; the "
          f"phase {run_s:.1f} s; {card}", flush=True)
    check(rate >= 0.97 * kernel_rate, f"the engine at {rate / kernel_rate:.1%} "
          "of B1's rate over the gossip window (limit 97%)")
    return dict(b1=out["b1"], b2=out["b2"], max_err=0)


def scrypt_p2p_phase(dev, card: str) -> dict:
    """Phase 27: phase 26's app on a scrypt share chain, mining off.
    Returns B5's launches and the verify path's max_abs_err."""
    import numpy as np
    import torch

    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import scrypt_torch as sct
    from otedama_tpu_torch.kernels import sha256_cuda as sc_k
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.pool.blockchain import MockChainClient

    phase(f"27 a scrypt share chain: `cli p2p` (no mining) catching up "
          f"{SCRYPT_P2P_CHAIN} scrypt shares from one node, each page "
          f"through the scrypt verify path around B5")
    claimed = compact_round_trip(SCRYPT_P2P_DIFFICULTY)
    Emulator = load_pg_emulator()
    overlay = Overlay(1, SCRYPT_P2P_CHAIN, SCRYPT_P2P_DIFFICULTY, "scrypt")
    info = overlay.info
    out: dict = {}

    async def run27(emu):
        app = p2p_app(dev, "scrypt", SCRYPT_P2P_DIFFICULTY, emu.dsn,
                      MockChainClient(), info["ports"], mine=False)
        try:
            await app.start()
            vlog = VerifyLog(app.validator, None)
            await until(lambda: len(app.p2p.node.peers) == 1, 30.0,
                        "the app's link")
            t_sync = time.monotonic()
            await app.p2p.request_sync()
            await until(lambda: app.p2p.chain.height == SCRYPT_P2P_CHAIN,
                        120.0, "the scrypt catch-up")
            out.update(
                catchup_s=time.monotonic() - t_sync, vlog=vlog,
                tip=app.p2p.chain.tip, state=await overlay.call("state", []),
                weights=app.p2p.weights(), full=app.p2p.chain.weights_full(),
                p2p=app.p2p.snapshot(), stats=dict(app.validator.stats),
                romix=scc.romix_launches.value,
                verify=scc.verify_launches.value, plain=sct.calls.value)
        finally:
            await app.stop()
            await overlay.call("stop")

    for counter in (scc.romix_launches, scc.verify_launches, sct.calls):
        counter.reset()
    try:
        with Emulator() as emu:
            asyncio.run(run27(emu))
    finally:
        overlay.close()
    vlog, stats, snap, state = out["vlog"], out["stats"], out["p2p"], out["state"]
    check(state["tips"] == [(out["tip"], SCRYPT_P2P_CHAIN)]
          and out["weights"] == out["full"] == state["weights"][0],
          "scrypt chain: tip or weights differ")
    wrong = sum(v != hashlib_verdict(c) for _, _, checks, verdicts, _
                in vlog.calls for c, v in zip(checks, verdicts))
    check(wrong == 0 and all(all(verdicts) for *_, verdicts, _ in vlog.calls),
          f"{wrong} scrypt verdicts differ from hashlib.scrypt's")
    check(out["romix"] == out["verify"] == stats["device_batches"]
          == len(vlog.calls) > 0 and out["plain"] == 0,
          f"B5 launches {out['romix']}, verify launches {out['verify']}, "
          f"device batches {stats['device_batches']}, calls "
          f"{len(vlog.calls)}, plain {out['plain']}")
    check(snap["verify_failures"] == 0 and stats["device_errors"] == 0
          and stats["tripwire_mismatches"] == 0, "scrypt rails fired")
    # the verify path against its plain version on one page
    _, _, checks, _, _ = vlog.calls[0]
    words = torch.from_numpy(st.headers_to_words(
        [c.header for c in checks]).view(np.int32)).to(dev)
    limbs = torch.from_numpy(np.stack([tgt.target_to_limbs(c.target)
                                       for c in checks]).view(np.int32)).to(dev)
    k = sc_k.K_WINNERS
    a = scc.scrypt_verify(words, limbs, len(checks), k=k).cpu().numpy()
    b = sct.scrypt_verify_step(words, limbs, len(checks) - 1,
                               k=k).cpu().numpy()
    max_err = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
    check(max_err == 0, "the scrypt verify path != plain on a sync page")
    print(f"   {SCRYPT_P2P_CHAIN} scrypt shares ground by hashlib.scrypt in "
          f"{info['grind_s']:.2f} s ({info['tries']} tries, difficulty "
          f"{SCRYPT_P2P_DIFFICULTY:g}, target {claimed:#x}); catch-up in "
          f"{out['catchup_s']:.3f} s = "
          f"{SCRYPT_P2P_CHAIN / out['catchup_s']:.0f} shares/s, "
          f"{snap['sync_pages_received']} pages; tips and weights equal; "
          f"every verdict = hashlib.scrypt's; page verify "
          f"{quantiles([c[1] for c in vlog.calls])}; B5 launches "
          f"{out['romix']} = verify launches = device batches; the verify "
          f"path = plain on a page ({len(checks)} lanes); {card}", flush=True)
    return dict(b5=out["romix"], max_err=max_err)


# -- phase 28: the durable share chain and the API, killed and cold-booted ------

DURABLE_CHAIN = 30_000    # > chain_tail_shares + one snapshot interval
DURABLE_GOSSIP_S = 10.0
DURABLE_SUFFIX = 2_000    # shares the overlay adds while the node is down
DURABLE_LAG_EVERY_S = 0.05


class RestoredLine(logging.Handler):
    """The app's "share chain restored" log line, its arguments kept
    (directory, height, source, events replayed, seconds, mode)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.args = None

    def emit(self, record):
        if record.msg.startswith("share chain restored"):
            self.args = tuple(record.args)


def thread_cpu_s(native_id: int) -> float:
    """CPU seconds (user + system) a thread of this process has used."""
    with open(f"/proc/self/task/{native_id}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def durable_node_process(conn, bootstrap, dsn, chain_dir) -> None:
    """Process A or B of phase 28: an ``Application`` as ``cli p2p
    --mine`` sets it, its chain durable in ``chain_dir`` and the API on,
    on the card. Serves the phase over ``conn``: ("catchup", (height,
    engine_off)) syncs to ``height`` (with the engine stopped, or under
    B1), then samples the engine's hash count and the persist lag;
    ("report", (t0, t1)) reads the window; ("finish", None) checks the
    chain and stops the app. Process A is SIGKILLed instead."""
    logging.getLogger("otedama.p2p.pool").setLevel(logging.ERROR)
    try:
        asyncio.run(_durable_node(conn, bootstrap, dsn, chain_dir))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


async def _durable_node(conn, bootstrap, dsn, chain_dir):
    import torch

    from otedama_tpu_torch.kernels import sha256_cuda as sc_k
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.pool.blockchain import MockChainClient

    loop = asyncio.get_running_loop()
    inbox: asyncio.Queue = asyncio.Queue()

    def read():
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            loop.call_soon_threadsafe(inbox.put_nowait, msg)

    threading.Thread(target=read, daemon=True).start()
    sc_k.load_library()
    restored = RestoredLine()
    applog = logging.getLogger("otedama.app")
    applog.addHandler(restored)
    applog.setLevel(logging.INFO)
    for counter in (sc_k.launches, sc_k.verify_launches, st.calls):
        counter.reset()
    app = p2p_app(torch.device("cuda", 0), "sha256d", P2P_DIFFICULTY, dsn,
                  MockChainClient(nbits=0x1D00FFFF), bootstrap, mine=True,
                  chain_dir=chain_dir)
    t0 = time.monotonic()
    await app.start()
    boot_s = time.monotonic() - t0
    chain, store = app.p2p.chain, app.p2p.chain.store
    vlog = VerifyLog(app.validator, app.engine)
    watch, lags, lag_task = HashWatch(), [], None
    await until(lambda: len(app.p2p.node.peers) == len(bootstrap), 30.0,
                "the node's links to the overlay")
    conn.send(("ready", dict(
        api_port=app.api.port, restored=restored.args, boot_s=boot_s,
        height=chain.height, archived=chain.archived_height,
        replayed=store.stats["replayed_records"],
        replay_s=store.stats["replay_seconds"])))

    async def sample_lag():
        while True:
            lags.append((time.monotonic(), store.persist_lag))
            await asyncio.sleep(DURABLE_LAG_EVERY_S)

    def pairs(call):
        return [(c.header, c.target) for c in call[2]]

    while True:
        cmd, arg = await inbox.get()
        if cmd == "catchup":
            target, engine_off = arg
            await engine_running(app)
            if engine_off:
                async with app._restart_lock:
                    await app.engine.stop()
                    t_s = time.monotonic()
                    await app.p2p.request_sync()
                    await until(lambda: chain.height >= target, 120.0,
                                "the catch-up")
                    catchup_s = time.monotonic() - t_s
                    await app.engine.start()
                await engine_running(app)
            else:
                t_s = time.monotonic()
                await app.p2p.request_sync()
                await until(lambda: chain.height >= target, 120.0,
                            "the catch-up")
                catchup_s = time.monotonic() - t_s
            calls = list(vlog.calls)
            watch.start(app.engine)
            lag_task = loop.create_task(sample_lag())
            # CPU time from here to the report: the writer thread, the
            # event loop's thread, the process
            threads = {"writer": store._thread.native_id,
                       "loop": threading.main_thread().native_id}
            cpu0 = ({k: thread_cpu_s(v) for k, v in threads.items()},
                    time.process_time(), time.monotonic())
            collected = GcWatch().__enter__()
            conn.send(("caught", dict(
                seconds=catchup_s, height=chain.height, calls=len(calls),
                page_s=[c[1] for c in calls], page=pairs(calls[-1]),
                pages=app.p2p.stats["sync_pages_received"],
                b2=sc_k.verify_launches.value,
                device_batches=app.validator.stats["device_batches"])))
        elif cmd == "report":
            t_g0, t_g1 = arg
            rate, rate_text = watch.between(t_g0, t_g1)
            wall = time.monotonic() - cpu0[2]
            cpu = {k: (thread_cpu_s(v) - cpu0[0][k]) / wall
                   for k, v in threads.items()}
            cpu["process"] = (time.process_time() - cpu0[1]) / wall
            collected.__exit__(None, None, None)
            # the API's registry synced and the engine read in one step
            app.sync_metrics()
            hashrate = app.engine.snapshot()["hashrate"]
            calls = list(vlog.calls)
            gossip = [c for c in calls if t_g0 <= c[0] <= t_g1]
            snap = app.p2p.snapshot()
            conn.send(("report", dict(
                rate=rate, rate_text=rate_text, hashrate=hashrate, cpu=cpu,
                gc=collected.summary(),
                lags=[lag for t, lag in lags if t_g0 <= t <= t_g1],
                gossip_s=[c[1] for c in gossip], calls=len(calls),
                batch=pairs(max(gossip, key=lambda c: len(c[2]))),
                wrong=sum(v != hashlib_verdict(c) for _, _, checks, verdicts, _
                          in calls for c, v in zip(checks, verdicts)),
                rejected=sum(not v for *_, verdicts, _ in calls
                             for v in verdicts),
                shares=sum(len(c[2]) for c in calls),
                chain=snap["chain"], p2p_rejects=snap["rejects"],
                verify_failures=snap["verify_failures"],
                stats=dict(app.validator.stats),
                b1=sc_k.launches.value, b2=sc_k.verify_launches.value,
                plain=st.calls.value)))
        else:
            watch.stop()
            lag_task.cancel()
            snap = app.p2p.snapshot()
            out = dict(tip=chain.tip, height=chain.height,
                       weights=chain.weights(), full=chain.weights_full(),
                       chain=snap["chain"], verify_failures=snap[
                           "verify_failures"], rejects=snap["rejects"],
                       stats=dict(app.validator.stats),
                       wrong=sum(v != hashlib_verdict(c)
                                 for _, _, checks, verdicts, _ in vlog.calls
                                 for c, v in zip(checks, verdicts)))
            await app.stop()
            out.update(b1=sc_k.launches.value, b2=sc_k.verify_launches.value,
                       plain=st.calls.value)
            conn.send(("finished", out))
            return


class DurableNode(Child):
    """The phase's end of ``durable_node_process``."""

    def __init__(self, name, bootstrap, dsn, chain_dir):
        super().__init__(name, durable_node_process, bootstrap, dsn,
                         chain_dir)

    def kill(self) -> None:
        self.proc.kill()                 # SIGKILL
        self.proc.join(30.0)


def scrape(port: int, path: str) -> tuple[float, str]:
    """(seconds, body) of one GET on the node's API."""
    import urllib.request

    t0 = time.monotonic()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10.0) as resp:
        body = resp.read().decode()
    return time.monotonic() - t0, body


def gauge(text: str, name: str) -> float | None:
    """The value of an unlabelled gauge in a Prometheus exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def cli_status(port: int) -> subprocess.CompletedProcess:
    """``python -m otedama_tpu_torch.cli status`` against the node's API,
    from a process of its own."""
    env = {**os.environ, "OTEDAMA_API_HOST": "127.0.0.1",
           "OTEDAMA_API_PORT": str(port)}
    return subprocess.run([sys.executable, "-m", "otedama_tpu_torch.cli",
                           "status"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


def durable_phase(dev, card: str, kernel_rate: float) -> dict:
    """Phase 28: ``cli p2p --mine`` with a durable chain and the API on the
    card, SIGKILLed in mid-gossip and cold-booted from its directory.
    Returns B1's and B2's launches over both processes (B2 held equal to
    its plain version at the path's shapes, or the phase fails)."""
    import shutil
    import tempfile

    from otedama_tpu_torch.kernels.card import Sampler

    phase(f"28 `cli p2p --mine` with p2p.chain_dir and the API on the card: "
          f"catch-up of {DURABLE_CHAIN} shares from {P2P_SEEDS} loopback "
          f"nodes, {DURABLE_GOSSIP_S:.0f} s of gossip under B1 with "
          f"/metrics, /health and `cli status`, a SIGKILL in mid-gossip, "
          f"{DURABLE_SUFFIX} shares more, a cold boot from the directory "
          f"and the suffix caught up under B1")
    Emulator = load_pg_emulator()
    overlay = Overlay(P2P_SEEDS, DURABLE_CHAIN, P2P_DIFFICULTY)
    info = overlay.info
    chain_dir = tempfile.mkdtemp(prefix="otedama-chain-")
    nodes: list = []
    out: dict = {}

    async def run28(emu_a, emu_b):
        loop = asyncio.get_running_loop()
        a = DurableNode("node process A", info["ports"], emu_a.dsn, chain_dir)
        nodes.append(a)
        ready = await a.reply("ready", 300.0)
        check(ready["height"] == 0 and ready["restored"][2] == "empty",
              f"process A did not boot empty: {ready}")
        port = ready["api_port"]
        out["a_caught"] = await a.ask("catchup", (DURABLE_CHAIN, True),
                                      "caught", 180.0)
        # gossip under B1: a batch of 500 a second; /metrics and the
        # chain's provider scraped after each, `cli status` meanwhile
        status = loop.run_in_executor(None, cli_status, port)
        scrapes, persisted = [], -1
        with Sampler(period=1.0) as sampled:
            t_g0 = time.monotonic()
            for k in range(int(DURABLE_GOSSIP_S)):
                await asyncio.sleep(max(0.0, t_g0 + k - time.monotonic()))
                await overlay.call("flood", (P2P_BATCH, 0))
                took, text = await loop.run_in_executor(None, scrape, port,
                                                        "/metrics")
                scrapes.append(took)
                persisted = max(persisted, gauge(
                    text, "otedama_chain_persisted_height") or -1)
                _, body = await loop.run_in_executor(None, scrape, port,
                                                     "/api/v1/stats/p2p")
                persisted = max(persisted, json.loads(body)["chain"][
                    "store"]["persisted_height"])
            t_g1 = t_g0 + DURABLE_GOSSIP_S
            await asyncio.sleep(max(0.0, t_g1 - time.monotonic()))
        out["card"], out["load"] = sampled.summary(), os.getloadavg()
        _, health = await loop.run_in_executor(None, scrape, port, "/health")
        _, engine_api = await loop.run_in_executor(
            None, scrape, port, "/api/v1/stats/engine")
        out["a_report"] = await a.ask("report", (t_g0, t_g1), "report")
        _, metrics = await loop.run_in_executor(None, scrape, port,
                                                "/metrics")
        _, body = await loop.run_in_executor(None, scrape, port,
                                             "/api/v1/stats/p2p")
        persisted = max(persisted, json.loads(body)["chain"]["store"][
            "persisted_height"], gauge(metrics,
                                       "otedama_chain_persisted_height"))
        out["status"] = await status
        # the SIGKILL, while A verifies and links the next batch
        await overlay.call("flood", (P2P_BATCH, 0))
        await asyncio.sleep(0.02)
        a.kill()
        out["b1_now"] = await loop.run_in_executor(None, b1_now, dev)
        out.update(health=json.loads(health), engine_api=json.loads(
            engine_api), metrics=metrics, scrapes=scrapes,
                   persisted=int(persisted), t_g0=t_g0, t_g1=t_g1)
        # the overlay goes on while the node is down
        for _ in range(DURABLE_SUFFIX // P2P_BATCH):
            await overlay.call("flood", (P2P_BATCH, 0))
        t_c = time.monotonic()
        while True:
            state = await overlay.call("state", [])
            if len(set(state["tips"])) == 1:
                break
            check(time.monotonic() < t_c + 60.0,
                  f"the overlay's tips: {set(state['tips'])}")
            await asyncio.sleep(0.25)
        target = state["tips"][0][1]
        b = DurableNode("node process B", info["ports"], emu_b.dsn, chain_dir)
        nodes.append(b)
        out["b_ready"] = await b.reply("ready", 300.0)
        out["b_caught"] = await b.ask("catchup", (target, False), "caught",
                                      180.0)
        out["b_finish"] = await b.ask("finish", None, "finished", 120.0)
        b.close()
        out["state"] = await overlay.call("state", [])
        out["target"] = target
        await overlay.call("stop")

    try:
        with Emulator() as emu_a, Emulator() as emu_b:
            t_run = time.monotonic()
            asyncio.run(run28(emu_a, emu_b))
            run_s = time.monotonic() - t_run
    finally:
        for node in nodes:
            if node.proc.is_alive():
                node.proc.kill()
            node.proc.join(30.0)
        overlay.close()
        shutil.rmtree(chain_dir, ignore_errors=True)
    a_caught, rep_a = out["a_caught"], out["a_report"]
    b_ready, b_caught, fin = out["b_ready"], out["b_caught"], out["b_finish"]
    state, persisted = out["state"], out["persisted"]
    # A: the catch-up and the gossip, every verdict hashlib's, no rail
    check(a_caught["height"] == DURABLE_CHAIN,
          f"A caught up to {a_caught['height']}")
    check(rep_a["wrong"] == 0 and rep_a["rejected"] == 0
          and not rep_a["p2p_rejects"] and rep_a["verify_failures"] == 0,
          f"A's verdicts: {rep_a['wrong']} differ from hashlib's, "
          f"{rep_a['rejected']} rejected, rejects {rep_a['p2p_rejects']}")
    stats_a = rep_a["stats"]
    check(rep_a["b2"] == stats_a["device_batches"] > 0
          and stats_a["device_errors"] == stats_a["tripwire_mismatches"]
          == stats_a["overflows"] == 0,
          f"A: B2 launches {rep_a['b2']}, device batches "
          f"{stats_a['device_batches']}, rails {stats_a}")
    check(rep_a["b1"] > 0 and rep_a["plain"] == 0,
          f"A: B1 launches {rep_a['b1']}, plain calls {rep_a['plain']}")
    store_a = rep_a["chain"]["store"]
    check(rep_a["chain"]["persist_failures"] == 0 and not store_a["degraded"]
          and store_a["writer_errors"] == 0 and store_a["ring_dropped"] == 0,
          f"A's store degraded: {store_a}")
    check(rep_a["chain"]["archived_height"] > 0
          and store_a["snapshot_height"] > 0,
          f"A archived {rep_a['chain']['archived_height']}, snapshot at "
          f"{store_a['snapshot_height']}")
    # the API on A: health from the card's supervision, the engine's rate,
    # the chain's gauges, `cli status`
    health = out["health"]
    check(health["status"] == "ok" and set(
        health["device_states"].values()) == {"healthy"},
          f"/health: {health}")
    metrics = out["metrics"]
    api_rate = gauge(metrics, "otedama_hashrate")
    check(api_rate is not None
          and abs(api_rate - rep_a["hashrate"]) <= 0.02 * rep_a["hashrate"]
          and abs(out["engine_api"]["hashrate"] - rep_a["hashrate"])
          <= 0.05 * rep_a["hashrate"],
          f"the API's engine rate: /metrics {api_rate}, the engine's "
          f"snapshot {rep_a['hashrate']}, /api/v1/stats/engine "
          f"{out['engine_api']['hashrate']}, the window {rep_a['rate']}")
    for name in ("otedama_chain_persist_lag", "otedama_chain_persisted_height",
                 "otedama_chain_archived_height",
                 "otedama_chain_writer_degraded",
                 "otedama_chain_snapshot_height", "otedama_p2p_chain_height",
                 "otedama_validation_device_ok"):
        check(gauge(metrics, name) is not None, f"/metrics lacks {name}")
    check(gauge(metrics, "otedama_chain_writer_degraded") == 0
          and gauge(metrics, "otedama_validation_device_ok") == 1,
          "/metrics: writer degraded or validation off")
    status = out["status"]
    check(status.returncode == 0, f"cli status: {status.stderr[-2000:]}")
    status_doc = json.loads(status.stdout)
    check(status_doc["p2p"]["chain"]["height"] >= DURABLE_CHAIN
          and status_doc["engine"]["algorithm"] == "sha256d",
          "cli status: the p2p height or the engine")
    # B: the cold boot restores at least what A's API called durable
    restored = b_ready["restored"]
    check(restored is not None and restored[2] == "snapshot"
          and restored[1] == b_ready["height"] >= persisted + 1,
          f"B restored {restored}, A's last scraped persisted height "
          f"{persisted}")
    suffix = out["target"] - b_ready["height"]
    pages_whole = -(-out["target"] // 200)
    check(b_caught["height"] == out["target"]
          and b_caught["b2"] == b_caught["device_batches"] > 0
          and b_caught["b2"] <= -(-suffix // 200) + P2P_SEEDS + 2
          and b_caught["b2"] < pages_whole // 4,
          f"B's suffix catch-up: {suffix} shares, B2 launches "
          f"{b_caught['b2']}, device batches {b_caught['device_batches']}, "
          f"the whole chain's pages {pages_whole}")
    check(state["tips"] == [(fin["tip"], out["target"])] * P2P_SEEDS
          and fin["height"] == out["target"]
          and fin["weights"] == fin["full"] == state["weights"][0],
          f"B's tip or weights: B at {fin['height']}, the overlay "
          f"{set(state['tips'])}")
    store_b = fin["chain"]["store"]
    check(fin["chain"]["persist_failures"] == 0 and not store_b["degraded"]
          and store_b["writer_errors"] == 0 and fin["wrong"] == 0
          and fin["verify_failures"] == 0 and not fin["rejects"]
          and fin["plain"] == 0 and fin["b1"] > 0
          and fin["b2"] == fin["stats"]["device_batches"],
          f"B: persist failures {fin['chain']['persist_failures']}, store "
          f"{store_b}, verdicts wrong {fin['wrong']}, B1 {fin['b1']}, B2 "
          f"{fin['b2']}, device batches {fin['stats']['device_batches']}")
    # B2 against its plain version at the path's shapes
    for name, pairs in (("A's last catch-up page", a_caught["page"]),
                        ("A's largest gossip batch", rep_a["batch"]),
                        ("B's last suffix page", b_caught["page"])):
        b2_against_plain(dev, pairs)
        print(f"   B2 vs plain version on {name} ({len(pairs)} shares): "
              "equal", flush=True)
    lags = sorted(rep_a["lags"])
    rate = rep_a["rate"]
    print(f"   A from an empty directory: {DURABLE_CHAIN} shares caught up "
          f"with the engine stopped in {a_caught['seconds']:.3f} s = "
          f"{DURABLE_CHAIN / a_caught['seconds']:.0f} shares/s, "
          f"{a_caught['pages']} pages, {a_caught['calls']} verify_batch "
          f"calls ({quantiles(a_caught['page_s'])}); archived "
          f"{rep_a['chain']['archived_height']}, snapshot at "
          f"{store_a['snapshot_height']}, segments {store_a['journal']} "
          f"{store_a['archive']}", flush=True)
    print(f"   A's gossip window, {DURABLE_GOSSIP_S:.0f} s of {P2P_BATCH} a "
          f"second under B1: verify_batch {quantiles(rep_a['gossip_s'])}; "
          f"persist lag (events, sampled every {DURABLE_LAG_EVERY_S * 1e3:.0f}"
          f" ms) p50 {lags[len(lags) // 2]}, p99 "
          f"{lags[min(len(lags) - 1, int(len(lags) * 0.99))]}, max "
          f"{lags[-1]} (n={len(lags)}); a /metrics scrape "
          f"{quantiles(out['scrapes'])}; {rep_a['shares']} verdicts = "
          f"hashlib's; B2 launches {rep_a['b2']} = device batches", flush=True)
    print(f"   the API: /health {health['status']} {health['device_states']};"
          f" otedama_hashrate {api_rate:.6g} = the engine's snapshot "
          f"{rep_a['hashrate']:.6g}, /api/v1/stats/engine "
          f"{out['engine_api']['hashrate']:.6g} (the window's steady rate "
          f"{rate:.6g}); persist lag gauge "
          f"{gauge(metrics, 'otedama_chain_persist_lag'):g}; `cli status` "
          f"read height {status_doc['p2p']['chain']['height']}", flush=True)
    print(f"   SIGKILL in mid-gossip; A's API last called durable height "
          f"{persisted}; B's cold boot: {restored[1]} shares via "
          f"{restored[2]}, {restored[3]} events replayed in "
          f"{restored[4]:.3f} s ({b_ready['boot_s']:.2f} s to a started "
          f"app); the suffix: {suffix} shares ({DURABLE_SUFFIX} added while "
          f"down) in {b_caught['seconds']:.3f} s = "
          f"{suffix / b_caught['seconds']:.0f} shares/s under B1, "
          f"{b_caught['pages']} pages, B2 launches {b_caught['b2']} = device "
          f"batches (the whole chain: {pages_whole} pages), page "
          f"{quantiles(b_caught['page_s'])}; B on the overlay's tip at "
          f"{fin['height']}, weights() = weights_full(); persist failures, "
          f"writer degraded 0", flush=True)
    cpu = rep_a["cpu"]
    print(f"   over A's gossip window: the card {out['card']}; B1 right after "
          f"it (the parent, A killed) {out['b1_now'] / 1e9:.3f} GH/s "
          f"({out['b1_now'] / kernel_rate:.1%} of phase 5's; the engine "
          f"{rep_a['rate'] / out['b1_now']:.1%} of it); CPU of a core "
          f"in A: the chain writer thread {cpu['writer']:.1%}, the event "
          f"loop's thread {cpu['loop']:.1%}, the process {cpu['process']:.1%};"
          f" the host's load average {out['load'][0]:.2f} over "
          f"{os.cpu_count()} CPUs; in A {rep_a['gc']}", flush=True)
    print(f"   engine over A's gossip window: {rep_a['rate_text']} = "
          f"{rate / kernel_rate:.1%} of phase 5's kernel rate; B1 launches "
          f"A {rep_a['b1']}, B {fin['b1']}; the phase {run_s:.1f} s; {card}",
          flush=True)
    check(rate >= 0.97 * kernel_rate, f"the engine at {rate / kernel_rate:.1%}"
          " of B1's rate over A's gossip window (limit 97%)")
    return dict(b1=rep_a["b1"] + fin["b1"], b2=rep_a["b2"] + fin["b2"])


def p2p_phases(dev, card: str, kernel_rate: float) -> dict:
    """Phases 26-27."""
    return dict(sha256d=p2p_phase(dev, card, kernel_rate),
                scrypt=scrypt_p2p_phase(dev, card))

# B6's known answers: digests of the JAX package's x11 chain (computed on
# the CPU with otedama_tpu.kernels.x11.x11_digest), which is not Dash's
# canonical x11 (its simd512 is an uncertified reconstruction)
X11_KNOWN = (
    ("the Dash genesis header", None,
     "aeae4827bdd6ab7ed8f9e1951b8d1b48f139b9e433de0f65edfe9eafaa85b808"),
    ("80 zero bytes", bytes(80),
     "af8b0ece21801d254651e014cba9ed6b663219ad3631627fd7040d7ade245850"),
    ("bytes 0..79", bytes(range(80)),
     "3373adcc639371de27e08b57dbf7c3137ccfbbf8f43f8d180810d8e1ec34af52"),
    ("80 bytes 0xff", b"\xff" * 80,
     "2e6e3f3d210093815da0675fa512ad3a5f11e7a883ea87196e842aafadedb62d"),
)
# the solo x11 main path's windows: (shares a second the mock chain's
# target is set for, seconds); the second at the rate of a pool's share
# target, where most groups of launches hold winners to re-check
X11_SOLO_WINDOWS = ((2.0, 20.0), (32.0, 12.0))
X11_FLUSHES = 8              # 1,024-share x11 flushes through the ledger
SOLO_X11_MIN_SHARE = 0.95    # phase 31's first window against B6's rate


def x11_value(header: bytes) -> int:
    """x11 of an 80-byte header through the port's host chain (numpy)."""
    from otedama_tpu_torch.kernels.x11 import x11_digest

    return int.from_bytes(x11_digest(header), "little")


# B6's kernels that hold fewer than 16 warps an SM, and why (PERF.md
# section 6): at 16 warps a thread has 128 registers, and these spill there
B6_FEWER_WARPS = {"blake_search_kernel": 8, "blake_verify_kernel": 8,
                  "stage_kernel<2> (bmw)": 12, "groestl_kernel": 12}


def b6_resources(dev) -> None:
    """Phase 1's part on B6: each kernel's registers, local memory (stack
    and spills), shared memory and resident warps from the CUDA runtime,
    ptxas's stack and spills, and its SASS by pipe (a rolled round loop's
    iteration, or the whole function); fails if a kernel spills, keeps a
    stack, or holds fewer warps than ``B6_FEWER_WARPS`` allows."""
    from otedama_tpu_torch.kernels import cuda_build
    from otedama_tpu_torch.kernels import x11_cuda as xc

    for k in xc.kernel_info(dev):
        print(f"   B6 {k['kernel']}: {k['threads']} threads a block, "
              f"{k['registers']} registers, {k['local_bytes']} B of local "
              f"memory a thread (stack and spills), {k['smem_bytes']} B of "
              f"shared memory a block, {k['warps_per_sm']} warps an SM",
              flush=True)
        check(k["local_bytes"] == 0, f"B6 {k['kernel']} spills or keeps a "
              f"stack: {k['local_bytes']} B of local memory")
        check(k["warps_per_sm"] >= B6_FEWER_WARPS.get(k["kernel"], 16),
              f"B6 {k['kernel']}: {k['warps_per_sm']} warps an SM")
    # ptxas's report, when this process compiled the library (the runtime's
    # local memory above is the check either way)
    stacks = [line.strip() for line in
              xc.build_info.get("ptxas", "").splitlines() if "stack frame" in line]
    check(all(line.startswith("0 bytes stack frame, 0 bytes spill stores")
              for line in stacks), f"B6 ptxas: {stacks}")
    if stacks:
        print(f"   B6 ptxas: {len(stacks)} functions, every one with 0 bytes "
              "of stack frame and spills", flush=True)
    for kernel in ("blake_search_kernel", "stage_kernel", "groestl_kernel",
                   "shavite_kernel", "simd_kernel", "echo_kernel"):
        for line in cuda_build.kernel_report(xc.build_info, kernel):
            if line.startswith("SASS"):
                print(f"   B6 {line}", flush=True)


def x11_phases(dev, card: str, clock_mhz: float, counts: dict) -> list[dict]:
    """Phases 29-33 (x11, kernel B6); ``counts``: the instructions a lane
    executes (``x11_cuda.chain_instructions()``). Returns the records of
    its search and verify kernels."""
    import numpy as np
    import torch

    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig
    from otedama_tpu_torch.db import connect_database
    from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
    from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.kernels import x11 as host
    from otedama_tpu_torch.kernels import x11_cuda as xc
    from otedama_tpu_torch.kernels import x11_torch as xt
    from otedama_tpu_torch.kernels.card import Sampler
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.pool.manager import PoolManager
    from otedama_tpu_torch.runtime import supervision
    from otedama_tpu_torch.runtime.search import JobConstants, X11CudaBackend
    from otedama_tpu_torch.runtime.validate import ValidationBackend
    from otedama_tpu_torch.stratum.server import AcceptedShare

    rng = np.random.default_rng(SEED + 11)
    full = 0xFFFFFFFF
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = {"search": 0, "verify": 0}

    def limbs_of(v: int) -> np.ndarray:
        return np.array([(v >> (224 - 32 * j)) & full for j in range(8)],
                        dtype=np.uint32)

    def host_buf(t):
        torch.cuda.synchronize(dev)
        return t.cpu().numpy().view(np.uint32)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    def equal_buffers(kind, name, a, b, k):
        """every word when n <= k, else the count and the min"""
        n = int(b[2 * k])
        sel = slice(None) if n <= k else np.r_[2 * k, 2 * k + 2]
        diff = np.abs(a[sel].astype(np.int64) - b[sel].astype(np.int64))
        check(not diff.any(), f"{name}: kernel {a.tolist()[:40]} != plain "
              f"{b.tolist()[:40]}")
        max_err[kind] = max(max_err[kind], int(diff.max()))
        return n

    def search_vs_plain(name, prefix, base, last, limbs, batch, k=16,
                        order=None):
        order = order or xt.cnt_variant_order()
        a = host_buf(xc.x11_search(prefix, base, last, limbs, batch=batch,
                                   k=k, device=dev, cnt_order=order))
        t0 = time.monotonic()
        b = host_buf(xt.x11_search_buffer(prefix, base, last, limbs,
                                          batch=batch, k=k, device=dev,
                                          cnt_order=order, chunk=1 << 20))
        plain_s = time.monotonic() - t0
        n = equal_buffers("search", name, a, b, k)
        print(f"   {name}: {batch} lanes, last {last}, k={k}, n={n}"
              f"{' (overflow: count and min)' if n > k else ''}, min_h0="
              f"{b[2 * k + 2]:#010x} equal", flush=True)
        return b, plain_s

    def b6_kernels(lanes):
        """the kernels a B6 call of ``lanes`` lanes launches on the card"""
        return 2 + 11 * len(xc.chunk_plan(lanes))

    def verify_vs_plain(name, words, limbs, count, k):
        w, t = on_card(words), on_card(limbs)
        a = host_buf(xc.x11_verify(w, t, count, k=k))
        t0 = time.monotonic()
        b = host_buf(xt.x11_verify_step(w, t, count - 1, k=k))
        plain_s = time.monotonic() - t0
        n = equal_buffers("verify", name, a, b, k)
        print(f"   {name}: {count} of {len(words)} rows, k={k}, n={n}"
              f"{' (overflow: count and min)' if n > k else ''} equal",
              flush=True)
        return b, plain_s

    # -- 29. known answer ------------------------------------------------------
    phase("29 B6 known answer: the x11 chain's digests of the Dash genesis "
          "header and three fixed headers")
    headers = [h if h is not None else host.DASH_GENESIS_HEADER
               for _, h, _ in X11_KNOWN]
    values = []
    for (name, _, want), h in zip(X11_KNOWN, headers):
        got = host.x11_digest(h).hex()
        check(got == want, f"{name}: the port's host chain gives {got}, "
              f"the JAX package's {want}")
        values.append(int.from_bytes(bytes.fromhex(want), "little"))
    # the verify kernel: each header twice, against its digest (passes) and
    # one below it (fails): only the exact 256-bit value does both
    rows = [h for h in headers for _ in (0, 1)]
    tl = np.stack([limbs_of(v - d) for v in values for d in (0, 1)])
    words = xt.headers_to_words(rows)
    b, _ = verify_vs_plain("verify: digest and digest - 1 as targets", words,
                           tl, len(rows), 8)
    check(int(b[16]) == 4 and b[:4].tolist() == [1, 3, 5, 7]
          and b[8:12].tolist() == [v >> 224 for v in values],
          f"verify known answer: {b.tolist()}")
    # the search kernel: the header's own nonce word as the base of a
    # one-lane window
    for (name, _, want), h, v in zip(X11_KNOWN, headers, values):
        base = int.from_bytes(h[76:80], "big")
        for delta, expect in ((0, 1), (1, 0)):
            a = host_buf(xc.x11_search(h[:76], base, 0, limbs_of(v - delta),
                                       batch=1, k=4, device=dev))
            check(int(a[8]) == expect and (not expect or (
                int(a[0]) == 0 and int(a[4]) == v >> 224)),
                  f"search known answer {name} (target - {delta}): "
                  f"{a.tolist()}")
        print(f"   {name}: {want} (B6 verify and search, the port's host "
              "chain)", flush=True)

    # -- 30. B6 against the plain version -----------------------------------
    phase("30 B6 vs x11_torch on the card, buffer for buffer")
    prefix = rng.integers(0, 256, 76, dtype=np.uint8).tobytes()
    few = limbs_of((1 << 238) - 1)             # ~4 winners in 2^20 lanes
    search_vs_plain("few winners", prefix, int(rng.integers(1 << 32)),
                    (1 << 20) - 1, few, 1 << 20)
    # a target at the best lane's digest and +-1: decided on the low limbs
    span, base = 1 << 12, int(rng.integers(1 << 32))
    hw = xt.search_words(prefix, base, span, dev)
    lanes = torch.stack(xt.digest_limbs(xt.chain_words(hw)), 1).cpu().numpy()
    best_lane = int(np.lexsort(lanes.T[::-1])[0])
    best = tgt.limbs_to_target(lanes[best_lane])
    for delta, expect in ((0, 1), (-1, 0), (1, 1)):
        b, _ = search_vs_plain(f"target = best lane's digest {delta:+d}",
                               prefix, base, span - 1, limbs_of(best + delta),
                               span)
        check(int(b[32]) == expect and (not expect or int(b[0]) == best_lane),
              f"target at the digest {delta:+d}: {b.tolist()}")
    # a target for a few winners at each count
    for count, top in ((1, 255), (37, 253), (xc.THREADS + 1, 251),
                       (xc.CHUNK + 1, 240), ((1 << 20) + 77, 238)):
        batch = max(count, 1 << 12)
        search_vs_plain(f"count {count}", prefix, int(rng.integers(1 << 32)),
                        count - 1, limbs_of(1 << top), batch)
    search_vs_plain("the window wraps 2^32", prefix, (1 << 32) - 1234,
                    (1 << 14) - 1, limbs_of(1 << 246), 1 << 14)
    b, _ = search_vs_plain("an empty window", prefix, 5, -1, limbs_of(full),
                           4096)
    check(int(b[32]) == 0 and int(b[34]) == full, "empty window")
    b, _ = search_vs_plain("table overflow n > k", prefix, 7, (1 << 14) - 1,
                           limbs_of(1 << 250), 1 << 14)
    check(int(b[32]) > 16, "the overflow case did not overflow")
    for variant in host.shavite.CNT_VARIANTS:
        search_vs_plain(f"shavite counter order {variant!r}", prefix,
                        int(rng.integers(1 << 32)), (1 << 12) - 1,
                        limbs_of(1 << 250), 1 << 12,
                        order=xt.cnt_variant_order(variant))
    # X11CudaBackend's bisecting rescan against every winner of the window
    backend = X11CudaBackend(dev, winner_depth=16)
    jc = JobConstants.from_header_prefix(prefix, (1 << 250) - 1)
    res = backend.search(jc, 12345, 3000)
    pb = host_buf(xt.x11_search_buffer(prefix, 12345, 2999, jc.limbs,
                                       batch=3000, k=3000, device=dev))
    check(int(pb[6000]) > 16, "the bisect case did not overflow")
    check([w.nonce_word for w in res.winners]
          == [(12345 + int(o)) & full for o in pb[:int(pb[6000])]],
          "X11CudaBackend's bisect winners != the plain version's")
    check(res.best_hash_hi == int(pb[6002]) and res.hashes == 3000,
          "bisect telemetry")
    backend.close()
    print(f"   X11CudaBackend bisect: {int(pb[6000])} winners in 3000 lanes "
          "equal, each re-derived through the host chain", flush=True)
    # the main path's launch: X11_CUDA_BATCH lanes, ~12 winners
    from otedama_tpu_torch.runtime.search import X11_CUDA_BATCH
    main_limbs = limbs_of((1 << 256) // X11_CUDA_BATCH * 12)
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    host_buf(xc.x11_search(prefix, 99, X11_CUDA_BATCH - 1, main_limbs,
                           batch=X11_CUDA_BATCH, k=16, device=dev))
    first_ms = (time.monotonic() - t0) * 1e3
    _, plain_main_s = search_vs_plain(
        f"the main path's launch ({X11_CUDA_BATCH} lanes)", prefix, 99,
        X11_CUDA_BATCH - 1, main_limbs, X11_CUDA_BATCH)
    print(f"   main launch: kernel {first_ms:.1f} ms (a call, host clock), "
          f"plain version {plain_main_s:.1f} s", flush=True)
    # the verify kernel: Byzantine rows, an overflow, a count short of rows
    hv = rng.integers(0, 256, (1024, 80), dtype=np.uint8)
    vl = limbs_of_digests(host.x11_digest_batch(hv).tobytes())
    pattern = np.where(rng.random(1024) < 1 / 9, -1,
                       rng.integers(0, 2, 1024))
    tl = vl.copy()
    for delta in (-1, 1):
        tl[pattern == delta] = limbs_step(vl[pattern == delta], delta)
    b, plain_verify_s = verify_vs_plain("Byzantine rows (one in 9)",
                                        xt.headers_to_words(hv), tl, 1024, 256)
    check(b[:int(b[512])].tolist() == np.nonzero(pattern == -1)[0].tolist(),
          "verify: failures != the forged rows")
    over = np.where(rng.random(1024) < 1 / 3, -1, 0)
    tl2 = vl.copy()
    tl2[over == -1] = limbs_step(vl[over == -1], -1)
    b, _ = verify_vs_plain("k overflow", xt.headers_to_words(hv), tl2, 1024,
                           16)
    check(int(b[32]) > 16, "the verify overflow case did not overflow")
    verify_vs_plain("count short of the rows", xt.headers_to_words(hv), tl,
                    1000, 256)
    torch.cuda.empty_cache()

    # -- 31. main path (a): solo x11 -------------------------------------------
    from otedama_tpu_torch.engine.jobs import header_from_share

    def solo_window(shares_per_s: float, window_s: float):
        """``Application`` solo on x11 for ``window_s`` against a mock chain
        whose target makes about ``shares_per_s`` shares; returns (B6
        launches, the steady rate)."""
        rate_guess = X11_CUDA_BATCH / first_ms * 1e3
        chain_target = (1 << 256) // int(rate_guess / shares_per_s)
        nbits = tgt.target_to_bits(chain_target)
        chain_target = tgt.bits_to_target(nbits)
        phase(f"31 main path: solo x11 Application on the card for "
              f"{window_s:.0f} s, mock chain nbits {nbits:#010x} (about "
              f"{shares_per_s:g} shares/s)")
        cfg = AppConfig()
        cfg.mining.algorithm = "x11"
        cfg.mining.device = "cuda"
        cfg.work.enabled = True
        cfg.work.poll_seconds = 0.5
        chain = MockChainClient(nbits=nbits)
        app = Application(cfg, chain=chain)
        shares, outcomes = [], []
        on_share, submit = app._on_share, chain.submit_block

        async def record_share(share):
            shares.append((share, app.worksource.get_job(share.job_id)))
            await on_share(share)

        async def record_submit(header):
            outcome = await submit(header)
            outcomes.append((header, outcome))
            return outcome

        app._on_share = record_share
        chain.submit_block = record_submit

        async def run31():
            await app.start()
            try:
                t_end = time.monotonic() + MAIN_PATH_BOUND_S
                while app.engine.state.value != "running":
                    check(time.monotonic() < t_end, "x11 engine never started")
                    check(not any(t.done() and not t.cancelled()
                                  and t.exception() for t in app._tasks),
                          "a background task failed before the engine "
                          "started")
                    await asyncio.sleep(0.05)
                watch.start(app.engine)
                h0, t0 = app.engine.stats.hashes, time.monotonic()
                with Sampler(1.0) as sampled:
                    await asyncio.sleep(window_s)
                h1, t1 = app.engine.stats.hashes, time.monotonic()
                watch.stop()
                return h1 - h0, t1 - t0, sampled.summary()
            finally:
                await app.stop()

        xc.search_launches.reset()
        xt.calls.reset()
        watch = HashWatch()
        hashes, seconds, clocks = asyncio.run(run31())
        launches, plain = xc.search_launches.value, xt.calls.value
        steady_rate, steady_text = watch.summary()
        backend = next(iter(app.engine.backends.values()))
        check(backend.name == "x11-cuda", f"the engine ran {backend.name}")
        check(launches > 0 and plain == 0,
              f"B6 launches {launches}, plain-version calls {plain}")
        check(shares, "no x11 share in the window")
        for share, job in shares:
            header = header_from_share(job, share.extranonce2, share.ntime,
                                       share.nonce_word)
            v = x11_value(header)
            check(v.to_bytes(32, "little") == share.digest
                  and v <= job.share_target,
                  f"x11 share {share.nonce_word:#x} fails the host chain")
        refused = sum(not o.accepted for _, o in outcomes)
        for header, outcome in outcomes:
            check(outcome.accepted == (int.from_bytes(hashlib.sha256(
                hashlib.sha256(header).digest()).digest(), "little")
                <= chain_target), "the mock chain's verdict != sha256d's")
        print(f"   {len(shares)} shares ({len(shares) / seconds:.1f}/s), each "
              f"re-hashed through the host chain at or under its target; "
              f"{len(outcomes)} block candidates submitted, {refused} "
              f"refused by the mock chain (it checks blocks by sha256d); "
              f"engine batch {app.engine.planned_batch(backend)} lanes, "
              f"{app.engine.config.pipeline_depth} a group; {hashes} hashes "
              f"in {seconds:.2f} s = {hashes / seconds / 1e6:.2f} MH/s over "
              f"the window; {steady_text}; B6 launches {launches}, "
              f"plain-version calls {plain}; {clocks}", flush=True)
        return launches, steady_rate

    solo = {rate: solo_window(rate, window_s)
            for rate, window_s in X11_SOLO_WINDOWS}
    main_launches = sum(launches for launches, _ in solo.values())

    # -- 32. main path (b): x11 shares at the pool ledger ------------------------
    phase(f"32 main path: {X11_FLUSHES} x11 flushes of 1,024 through "
          "PoolManager.on_share_batch -> B6's verify kernel")

    def byzantine_difficulty(v: int) -> float:
        """the float difficulty whose target is the largest below v"""
        s = (tgt.DIFF1_TARGET << 32) // v + 1
        while (tgt.DIFF1_TARGET << 32) // s >= v:
            s += 1
        return s / (1 << 32)

    def flush(first):
        hd = rng.integers(0, 256, (1024, 80), dtype=np.uint8)
        digests = host.x11_digest_batch(hd)
        byz = rng.random(1024) < 1 / 256
        batch, honest = [], []
        for i in range(1024):
            d = digests[i].tobytes()
            v = int.from_bytes(d, "little")
            diff = (byzantine_difficulty(v) if byz[i]
                    else tgt.target_to_difficulty(v) * 0.5)
            honest.append(v <= tgt.difficulty_to_target(diff))
            batch.append(AcceptedShare(
                session_id=first + i, worker_user=f"x.{(first + i) % 512}",
                job_id="x11-ledger", difficulty=diff, actual_difficulty=diff,
                digest=d, header=hd[i].tobytes(),
                extranonce2=struct.pack(">I", first + i), ntime=1_700_000_000,
                nonce_word=0, is_block=False, submitted_at=1_700_000_000.0,
                algorithm="x11"))
        return batch, honest

    t0 = time.monotonic()
    flushes = [flush(1024 * f) for f in range(X11_FLUSHES)]
    print(f"   {X11_FLUSHES * 1024} x11 shares built and hashed by the host "
          f"chain in {time.monotonic() - t0:.1f} s", flush=True)
    pm = PoolManager(connect_database(":memory:"), MockChainClient())
    pm.validator = ValidationBackend(min_batch=128, tripwire_rate=0.05,
                                     seed=SEED)
    xc.verify_launches.reset()
    xt.calls.reset()

    async def run32():
        outs, secs = [], []
        for batch, _ in flushes:
            t = time.monotonic()
            outs.append(await pm.on_share_batch(batch))
            secs.append(time.monotonic() - t)
        return outs, secs

    outs, secs = asyncio.run(run32())
    ledger_launches, ledger_plain = xc.verify_launches.value, xt.calls.value
    snap = pm.validator.snapshot()
    honest_total = 0
    for (batch, honest), outcomes_ in zip(flushes, outs):
        for ok, outcome in zip(honest, outcomes_):
            check(outcome == (("ok", "") if ok
                              else ("err", "share failed validation")),
                  f"ledger outcome {outcome} != the host chain's verdict {ok}")
        honest_total += sum(honest)
    total = X11_FLUSHES * 1024
    check(pm.shares.count() == honest_total
          and pm.ledger_stats["shares_ok"] == honest_total
          and pm.ledger_stats["shares_rejected"] == total - honest_total,
          f"books: {pm.shares.count()} shares, {pm.ledger_stats}, honest "
          f"{honest_total}")
    check(snap["device_batches"] == X11_FLUSHES
          and snap["validated_device"] == total and snap["device_errors"] == 0
          and snap["tripwire_mismatches"] == 0 and snap["overflows"] == 0
          and snap["host_batches"] == 0,
          f"validator snapshot {snap}")
    check(ledger_launches == X11_FLUSHES and ledger_plain == 0,
          f"B6 verify launches {ledger_launches}, plain calls {ledger_plain}")
    rates = sorted(1024 / s for s in secs)
    print(f"   {total} shares in {sum(secs):.2f} s = {total / sum(secs):.0f} "
          f"shares/s; per flush median {rates[len(rates) // 2]:.0f}, min "
          f"{rates[0]:.0f}, max {rates[-1]:.0f}; every outcome = the host "
          f"chain's; books: {pm.shares.count()} shares = the honest ones, "
          f"{total - honest_total} rejected; tripwire checks "
          f"{snap['tripwire_checks']}, mismatches 0, device errors 0, "
          f"overflows 0; B6 verify launches {ledger_launches}, plain-version "
          f"calls {ledger_plain}", flush=True)
    # the validator's x11 dispatches at once, as P2P share batches come
    # beside the ledger's flushes: each flush on an executor thread of its
    # own, in rounds, every buffer against the plain version's
    from otedama_tpu_torch.runtime.validate import ShareCheck, \
        dispatch_executor
    v = pm.validator
    rows = []
    for batch, _ in flushes:
        targets = [tgt.difficulty_to_target(s.difficulty) for s in batch]
        words = xt.headers_to_words(np.stack([
            np.frombuffer(s.header, np.uint8) for s in batch]))
        limbs = np.stack([tgt.target_to_limbs(t) for t in targets])
        plain = host_buf(xt.x11_verify_step(on_card(words), on_card(limbs),
                                            len(batch) - 1, k=v.k))
        rows.append(([ShareCheck(s.header, t, "x11")
                      for s, t in zip(batch, targets)], plain))
    xc.verify_launches.reset()
    concurrent_rounds = 4
    for r in range(concurrent_rounds):
        futures = [dispatch_executor().submit(v._device_buffer, "x11",
                                              checks, v.k)
                   for checks, _ in rows]
        for i, (f, (_, plain)) in enumerate(zip(futures, rows)):
            equal_buffers("verify", f"concurrent dispatch {i}, round {r}",
                          f.result(), plain, v.k)
    check(xc.verify_launches.value == concurrent_rounds * len(rows),
          f"concurrent dispatches: {xc.verify_launches.value} B6 launches")
    print(f"   {concurrent_rounds} rounds of {len(rows)} x11 dispatches at "
          f"once on one validator (its dispatch executor's threads, one "
          f"stream): every buffer = the plain version's", flush=True)
    del pm

    # -- 33. times ---------------------------------------------------------------
    phase("33 B6 times beside the bound; a sha256d -> x11 -> sha256d switch "
          "with an x11 probe")
    stream = torch.cuda.Stream(dev)
    out = torch.empty(sc.winner_buffer_words(16), dtype=torch.int32,
                      device=dev)
    reps, rounds = 3, 3

    def time_search(lanes):
        xc.x11_search(prefix, 0, lanes - 1, limbs_of(0), batch=lanes, k=16,
                      device=dev, stream=stream, out=out)
        per = []
        for _ in range(rounds):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            for _ in range(reps):
                xc.x11_search(prefix, 0, lanes - 1, limbs_of(0), batch=lanes,
                              k=16, device=dev, stream=stream, out=out)
            e1.record(stream)
            e1.synchronize()
            per.append(e0.elapsed_time(e1) / reps)
        return sorted(per)[rounds // 2], per

    counted = counts["chain"]
    total, alu, fma = (counted[k] for k in ("total", "alu", "fma"))
    longest = max(v["seconds"] for v in counts.values())
    print(f"   B6 a lane, from the SASS of its counting build (twelve builds "
          f"from phase 1 on, the longest {longest:.1f} s): {total} "
          f"instructions, ALU pipe {alu} ({alu / total:.1%}), FMA pipe "
          f"{fma} ({fma / total:.1%}), {counted['smem_words']} "
          f"shared-memory words; by stage "
          + ", ".join(f"{name} {v['total']}/{v['alu']}/{v['fma']}/"
                      f"{v['smem_words']} ({v['seconds']:.0f} s)"
                      for name, v in counts.items() if name != "chain")
          + " (all/ALU/FMA/shared words, the build's time)", flush=True)
    per_lane, origin = xc.bound_chain(counted)
    first = xc.ONE_KERNEL_CHAIN
    print(f"   the bound takes {per_lane['alu'] + per_lane['fma']} integer "
          f"instructions and {per_lane['smem_words']} shared-memory words a "
          f"lane: {origin} (the one-kernel design's: "
          f"{first['alu'] + first['fma']} and {first['smem_words']})",
          flush=True)
    with Sampler() as sampled:
        search_times = {lanes: time_search(lanes)
                        for lanes in sorted({1 << 20, 1 << 22, X11_CUDA_BATCH,
                                             1 << 24})}
        stage_ms = xc.stage_times(dev, X11_CUDA_BATCH, stream=stream)

    def bound(lanes, verify=False, chain=None):
        """(bound ms, by, text): the largest of the three bounds, by
        "bytes" or else "operations" (a table lookup is one), as the
        kernels line takes them; the text names each term"""
        terms = xc.bound_ms(lanes, sms, clock_mhz, chain or per_lane,
                            verify=verify)
        top = max(("operations", "shared-memory reads", "bytes"),
                  key=terms.get)
        text = ", ".join(f"{k} {v:.4f} ms" for k, v in terms.items())
        return terms[top], "bytes" if top == "bytes" else "operations", text

    for lanes, (ms, per) in search_times.items():
        b_ms, by, text = bound(lanes)
        print(f"   search {lanes} lanes: {ms:.3f} ms ({', '.join(f'{t:.3f}' for t in per)}) "
              f"= {lanes / ms / 1e3:.2f} MH/s; bound {b_ms:.3f} ms by {by} "
              f"({b_ms / ms:.1%} of it; {text})", flush=True)
    print(f"   {sampled.summary()}", flush=True)
    stage_sum = 0.0
    for name, per in stage_ms.items():
        ms = sorted(per)[len(per) // 2]
        stage_sum += ms
        b_ms, _, text = bound(X11_CUDA_BATCH, chain=counts[name])
        print(f"   stage {name} alone over {X11_CUDA_BATCH} lanes: {ms:.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in per)}); its bound "
              f"{b_ms:.3f} ms ({b_ms / ms:.1%}; {text})", flush=True)
    print(f"   the stages' sum {stage_sum:.3f} ms against the chain's "
          f"{search_times[X11_CUDA_BATCH][0]:.3f} ms; {card}", flush=True)
    search_ms = search_times[X11_CUDA_BATCH][0]
    b6_rate = X11_CUDA_BATCH / search_ms * 1e3
    for rate, (_, steady) in solo.items():
        print(f"   solo x11 at about {rate:g} shares/s (phase 31): steady "
              f"{steady / 1e6:.2f} MH/s = {steady / b6_rate:.1%} of B6's "
              f"{b6_rate / 1e6:.2f} MH/s at {X11_CUDA_BATCH} lanes",
              flush=True)
    # at a solo miner's share rate the engine keeps B6 busy
    steady = solo[X11_SOLO_WINDOWS[0][0]][1]
    check(steady >= SOLO_X11_MIN_SHARE * b6_rate,
          f"solo x11 at {steady / b6_rate:.1%} of B6's rate")
    search_bound, search_by, _ = bound(X11_CUDA_BATCH)
    # a 1,024-share verify call at the ledger's size
    w, t = on_card(xt.headers_to_words(hv)), on_card(tl)
    vout = torch.empty(sc.winner_buffer_words(256), dtype=torch.int32,
                       device=dev)
    xc.x11_verify(w, t, 1024, k=256, stream=stream, out=vout)
    per = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        for _ in range(10):
            xc.x11_verify(w, t, 1024, k=256, stream=stream, out=vout)
        e1.record(stream)
        e1.synchronize()
        per.append(e0.elapsed_time(e1) / 10)
    verify_ms = sorted(per)[rounds // 2]
    verify_bound, verify_by, text = bound(1024, verify=True)
    print(f"   verify, 1,024 shares a call: {verify_ms:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in per)}); bound {verify_bound:.4f} "
          f"ms by {verify_by} ({text}): 1,024 lanes fill at most "
          f"{1024 // xc.THREADS} of {sms} SMs, so a call is about one "
          f"lane's chain, stage after stage; plain version "
          f"{plain_verify_s * 1e3:.0f} ms", flush=True)
    print(f"   bound: a lane's {per_lane['alu']} ALU-pipe and "
          f"{per_lane['fma']} FMA-pipe instructions and "
          f"{per_lane['smem_words']} shared-memory "
          f"words on {sms} SMs x {xc.INT_LANES_PER_SM} integer lanes (the "
          f"ALU pipe {xc.ALU_LANES_PER_SM} of them) x {clock_mhz:.0f} MHz; "
          f"{card}", flush=True)

    manager = AlgorithmManager("cuda", device=str(dev))
    switch_shares, jobs, downs = [], {}, []

    async def on_switch_share(s):
        switch_shares.append(s)

    async def run33():
        sha = manager.prepare_backend("sha256d", warm_count=MAIN_BATCH)
        engine = MiningEngine({sha.name: sha}, on_share=on_switch_share,
                              config=EngineConfig())

        def new_job(job_id, algorithm, target):
            jobs[job_id] = smoke_job(job_id, algorithm, target)
            engine.set_job(jobs[job_id])

        await engine.start()
        try:
            new_job("s33-sha0", "sha256d", SUPERVISED_TARGET)
            await asyncio.sleep(1.5)
            x11 = await manager.prepare_backend_async(
                "x11", warm_count=engine.planned_batch)
            downs.append(await engine.switch_algorithm("x11", {x11.name: x11}))
            new_job("s33-x11", "x11", (1 << 256) // (1 << 24))
            await asyncio.sleep(3.0)
            sha = await manager.prepare_backend_async(
                "sha256d", warm_count=engine.planned_batch)
            downs.append(await engine.switch_algorithm("sha256d",
                                                       {sha.name: sha}))
            new_job("s33-sha1", "sha256d", SUPERVISED_TARGET)
            await asyncio.sleep(1.5)
        finally:
            await engine.close()
        return engine

    xc.search_launches.reset()
    engine = asyncio.run(run33())
    switch_launches = xc.search_launches.value
    n = check_shares(switch_shares, jobs)
    per_job = {j: sum(s.job_id == j for s in switch_shares) for j in jobs}
    check(per_job["s33-sha0"] and per_job["s33-sha1"],
          f"a sha256d side mined no share: {per_job}")
    check(switch_launches > 0 and max(downs) < 0.5,
          f"x11 side: {switch_launches} B6 launches, downtimes {downs}")
    probe = manager.backend_for("x11")
    xc.search_launches.reset()
    jc, res, base, count = engine._probe_search(probe)
    probe_launches = xc.search_launches.value
    expect = supervision.expected_probe_winners("x11", jc, base, count)
    check(supervision.verify_probe_results("x11", jc, res, base, count),
          "the x11 probe failed the host chain")
    probe.close()
    print(f"   switch downtimes {downs[0] * 1e3:.2f} ms into x11, "
          f"{downs[1] * 1e3:.2f} ms back; shares by job {per_job}, {n} "
          f"re-hashed (sha256d by hashlib, x11 by the host chain); B6 "
          f"launches on the x11 side {switch_launches}; an x11 probe: "
          f"{probe_launches} B6 launches (warmup, then {count} lanes, "
          f"{len(expect)} winners), verified against the host chain",
          flush=True)

    return [{
        "name": "x11_search",
        "route": "cuda",
        "source": "otedama_tpu_torch/kernels/csrc/x11.cu",
        "replaces": "otedama_tpu/kernels/x11/jnp_chain.py:853",
        "launches": main_launches,
        "max_abs_err": max_err["search"],
        "ms": search_ms,
        "plain_ms": plain_main_s * 1e3,
        "bound_ms": search_bound,
        "bound_by": search_by,
        "library_ms": None,
        "path": (f"solo x11 Application (phase 31): {main_launches} "
                 f"launches of {X11_CUDA_BATCH} lanes; the x11 side of a "
                 f"warm switch (phase 33): {switch_launches}; a launch is "
                 f"one call, {b6_kernels(X11_CUDA_BATCH)} kernel launches "
                 f"on the card (2 + 11 x {X11_CUDA_BATCH // xc.CHUNK} "
                 f"chunks)"),
    }, {
        "name": "x11_verify",
        "route": "cuda",
        "source": "otedama_tpu_torch/kernels/csrc/x11.cu",
        "replaces": "otedama_tpu/kernels/x11/jnp_chain.py:878",
        "launches": ledger_launches,
        "max_abs_err": max_err["verify"],
        "ms": verify_ms,
        "plain_ms": plain_verify_s * 1e3,
        "bound_ms": verify_bound,
        "bound_by": verify_by,
        "library_ms": None,
        "path": (f"pool ledger on_share_batch, x11 flushes of 1,024 (phase "
                 f"32): {ledger_launches} launches, each one call of "
                 f"{b6_kernels(1024)} kernel launches on the card (2 + 11 x "
                 f"1 chunk)"),
    }]


# -- ethash (kernels B7a-B7c) -------------------------------------------------

ETHASH_SOLO_S = 20.0          # phase 37's steady window at epoch 0
ETHASH_FLUSHES = 8            # 1,024-share ethash flushes through the ledger
SOLO_ETHASH_MIN_SHARE = 0.95  # phase 37's window against B7b full's rate
ETHASH_DAG_SLICE = 1 << 20    # items a plain build_dataset call (phase 34)
ETHASH_PLAIN_SLICE = 1 << 22  # lanes a plain hashimoto pass (phase 35)
# B7c's counts in phase 35: none, one, an idle pair in a quad, one past a
# block of 64 shares, an idle pair at the end, the ledger's flush
B7C_COUNTS = (0, 1, 3, 129, 1023, 1024)
# the L2 probe: chains of L2_PROBE_STEPS rows, in waves (an SM's resident
# blocks on every SM) quadrupled from 1 up to L2_PROBE_MAX_WAVES until a
# size adds under L2_PROBE_PLATEAU to the rate
L2_PROBE_STEPS = 2048
L2_PROBE_MAX_WAVES = 64
L2_PROBE_PLATEAU = 0.01


def ethash_limbs_of(v: int):
    import numpy as np

    return np.array([(v >> (224 - 32 * j)) & 0xFFFFFFFF for j in range(8)],
                    dtype=np.uint32)


def ethash_oracle(full_size: int, cache, header_hashes, nonces):
    """The host oracle's results (``hashimoto_light_batch``) of many
    shares, 1,024 a process on up to 8 spawned processes (a pass is ~5 s
    of one core for 1,024 shares, and threads share one interpreter
    lock): ``[N, 32]`` uint8. Every process it starts ends with it."""
    import multiprocessing

    import numpy as np

    from otedama_tpu_torch.kernels import ethash as eth

    hh = np.asarray(header_hashes, dtype=np.uint8).reshape(-1, 32)
    nn = np.asarray(nonces, dtype=np.uint64)
    parts = [(hh[i:i + 1024], nn[i:i + 1024]) for i in range(0, len(nn), 1024)]
    workers = max(1, min(8, len(parts), os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        res = [r[1] for r in pool.map(
            eth.hashimoto_light_batch, [full_size] * len(parts),
            [cache] * len(parts), [p[0] for p in parts], [p[1] for p in parts])]
    return np.concatenate(res) if res else np.zeros((0, 32), np.uint8)


# B7b light's resident warps an SM before its redesign (the one-thread
# light core, 154 registers); the quad core must run more
ETHASH_LIGHT_WARPS_BEFORE = 12


def l2_probe_rate(dev, stream) -> tuple[float, str]:
    """The L2's rate for B7a's and B7b light's reads (the L2 probe of
    ``ethash.cu``: random 64-byte rows of a 16 MiB buffer, a quarter a
    thread of a quad, many in flight), in bytes/s: the highest over its
    sizes (waves quadrupled until the rate stops rising), and a line on
    it that says whether it stopped (else it is a lower estimate)."""
    import torch

    from otedama_tpu_torch.kernels import ethash_cuda as ec

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    buf = torch.randint(-(1 << 31), 1 << 31, (1 << ec.PROBE_ROW_BITS, 16),
                        dtype=torch.int32, device=dev, generator=gen)
    info, = ec.kernel_info(dev, (ec.PROBE_KERNEL,))
    wave = (torch.cuda.get_device_properties(dev).multi_processor_count
            * info["blocks_per_sm"])
    sink = torch.empty(L2_PROBE_MAX_WAVES * wave * ec.THREADS,
                       dtype=torch.int32, device=dev)
    rates, parts, waves = [], [], 1
    while waves <= L2_PROBE_MAX_WAVES:
        blocks = waves * wave
        ms, per = median_ms(lambda: ec.l2_probe(buf, blocks, L2_PROBE_STEPS,
                                                stream=stream, sink=sink),
                            stream, reps=3)
        nbytes = ec.probe_bytes(blocks, L2_PROBE_STEPS)
        rates.append(nbytes / ms * 1e3)
        parts.append(f"{waves} wave(s), {nbytes / 1e9:.2f} GB in {ms:.4f} ms "
                     f"({', '.join(f'{t:.4f}' for t in per)}) = "
                     f"{rates[-1] / 1e12:.3f} TB/s")
        if len(rates) > 1 and rates[-1] / rates[-2] - 1 < L2_PROBE_PLATEAU:
            break
        waves *= 4
    rise = rates[-1] / rates[-2] - 1 if len(rates) > 1 else float("inf")
    verdict = (f"its plateau (the last size {rise:+.2%})"
               if rise < L2_PROBE_PLATEAU else
               f"still rising at {L2_PROBE_MAX_WAVES} waves ({rise:+.2%}): a "
               "lower estimate of the L2's rate")
    return max(rates), (
        f"L2 probe, random 64-byte rows of 16 MiB, {info['registers']} "
        f"registers, a wave {wave} blocks ({info['blocks_per_sm']} an SM) of "
        f"{L2_PROBE_STEPS} steps: {'; '.join(parts)}; "
        f"{max(rates) / 1e12:.3f} TB/s, {verdict}")


def l2_share(kind: str, lanes: int, ms: float, probe: float) -> str:
    """A kernel's cache-row bytes through L2, the rate they imply in
    ``ms`` and its share of the probe's rate ``probe``."""
    from otedama_tpu_torch.kernels import ethash_cuda as ec

    nbytes = ec.row_bytes(kind, lanes)
    rate = nbytes / ms * 1e3
    return (f"{nbytes / 1e9:.1f} GB of cache rows through L2 = "
            f"{rate / 1e12:.3f} TB/s, {rate / probe:.1%} of the probe's")


def ethash_resources(dev) -> None:
    """Phase 1's part on B7: each kernel's registers, local memory (stack
    and spills) and resident warps from the CUDA runtime, and ptxas's stack
    and spills; fails if a kernel spills or keeps a stack, or if B7b light
    runs no more warps an SM than before its redesign."""
    from otedama_tpu_torch.kernels import cuda_build
    from otedama_tpu_torch.kernels import ethash_cuda as ec

    for k in ec.kernel_info(dev):
        print(f"   B7 {k['kernel']}: {k['threads']} threads a block, "
              f"{k['registers']} registers, {k['local_bytes']} B of local "
              f"memory a thread (stack and spills), {k['warps_per_sm']} "
              "warps an SM", flush=True)
        check(k["local_bytes"] == 0, f"B7 {k['kernel']} spills or keeps a "
              f"stack: {k['local_bytes']} B of local memory")
        if k["kernel"] == "search_light_kernel":
            check(k["warps_per_sm"] > ETHASH_LIGHT_WARPS_BEFORE,
                  f"B7b light runs {k['warps_per_sm']} warps an SM, not more "
                  f"than the one-thread core's {ETHASH_LIGHT_WARPS_BEFORE}")
    stacks = [line.strip() for line in
              ec.build_info.get("ptxas", "").splitlines() if "stack frame" in line]
    check(all(line.startswith("0 bytes stack frame, 0 bytes spill stores")
              for line in stacks), f"B7 ptxas: {stacks}")
    if stacks:
        print(f"   B7 ptxas: {len(stacks)} functions, every one with 0 bytes "
              "of stack frame and spills", flush=True)
    # the full search is straight-line code; the others' hot loop is 16
    # parents of the quad core (a thread's quarter of four items)
    for kernel in ec.KERNELS:
        for line in cuda_build.kernel_report(
                ec.build_info, kernel, loop=kernel != "search_full_kernel"):
            if line.startswith("SASS"):
                print(f"   B7 {line}", flush=True)


def ethash_kernel_phases(dev, card: str, clock_mhz: float, counts) -> dict:
    """Phases 34-36 (ethash, kernels B7a-B7c) at epoch 0; ``counts``: a
    future of ``ethash_cuda.instruction_counts()``. Returns the kernels'
    records (by name) and the epoch's state for phases 37-38."""
    import numpy as np
    import torch

    from otedama_tpu_torch.kernels import ethash as eth
    from otedama_tpu_torch.kernels import ethash_cuda as ec
    from otedama_tpu_torch.kernels import ethash_torch as et
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.kernels.card import Sampler
    from otedama_tpu_torch.kernels.sha256_cuda import winner_buffer_words

    rng = np.random.default_rng(SEED + 13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = {"dag": 0, "full": 0, "light": 0, "verify": 0}
    plain_ms = {}

    def host_buf(t):
        torch.cuda.synchronize(dev)
        return t.cpu().numpy().view(np.uint32)

    def equal(kind, name, a, b, k):
        """every word when n <= k, else the count and the min"""
        n = int(b[2 * k])
        sel = slice(None) if n <= k else np.r_[2 * k, 2 * k + 2]
        diff = np.abs(a[sel].astype(np.int64) - b[sel].astype(np.int64))
        check(not diff.any(), f"{name}: kernel {a.tolist()[:40]} != plain "
              f"{b.tolist()[:40]}")
        max_err[kind] = max(max_err[kind], int(diff.max()))
        return n

    # -- 34. epoch 0 -------------------------------------------------------
    phase("34 ethash epoch 0: the compiled cache generator against the "
          "python chain, the epoch-0 cache, the DAG by B7a")
    seed0 = eth.seed_hash(0)
    for rows in (61, 1021):
        t0 = time.monotonic()
        want = eth._python_make_cache(rows, seed0)
        py_s = time.monotonic() - t0
        got = eth.make_cache(rows * eth.HASH_BYTES, seed0)
        check(np.array_equal(got, want), f"the compiled generator != the "
              f"python chain at {rows} rows")
        print(f"   {rows} rows: the compiled generator = the python chain "
              f"({py_s:.2f} s)", flush=True)
    full_size, rows = eth.dataset_size(0), eth.cache_size(0) // eth.HASH_BYTES
    t0 = time.monotonic()
    cache = eth.make_cache(eth.cache_size(0), seed0)
    cache_s = time.monotonic() - t0
    cache_d = ec.cache_tensor(cache, dev)
    n_items, n_pages = full_size // eth.HASH_BYTES, full_size // eth.MIX_BYTES
    print(f"   epoch 0: cache {rows} rows ({cache.nbytes} B) built in "
          f"{cache_s:.3f} s by the compiled generator "
          f"({ec.cuda_build.HOST_FLAGS}); DAG {n_items} items, {n_pages} "
          f"pages ({full_size} B); generator {eth.generator_info}", flush=True)
    stream = torch.cuda.Stream(dev)
    ec.dag_launches.reset()
    t0 = time.monotonic()
    dag = ec.build_dag(cache_d, full_size, stream=stream)
    torch.cuda.synchronize(dev)
    first_s = time.monotonic() - t0
    check(ec.dag_launches.value == 1, "build_dag: not one launch")
    # its time: rebuilds into the same pages (CUDA events)
    dag_ms, dag_rounds = median_ms(
        lambda: ec.build_dag(cache_d, full_size, stream=stream, out=dag),
        stream, reps=1, rounds=3)
    # the whole DAG against the plain version, every word
    cache_p = et.source_tensor(cache, dev)
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    plain = et.build_dataset(cache_p, full_size, chunk=ETHASH_DAG_SLICE)
    torch.cuda.synchronize(dev)
    plain_ms["dag"] = (time.monotonic() - t0) * 1e3
    diff = int(((dag.view(-1, 16).to(torch.int64) & 0xFFFFFFFF) - plain)
               .abs().max())
    del plain
    check(diff == 0, f"B7a != build_dataset on the {n_items} items")
    max_err["dag"] = diff
    host_items = [0, 1, n_items - 1] + [int(x) for x in
                                         rng.integers(0, n_items, 5)]
    got_host = dag.view(-1, 16)[torch.tensor(host_items, device=dev)].cpu().numpy()
    for i, row in zip(host_items, got_host):
        check(np.array_equal(row.view(np.uint32), eth.calc_dataset_item(cache, i)),
              f"B7a item {i} != calc_dataset_item")
    print(f"   B7a: the DAG in {first_s:.3f} s (first call, host clock); "
          f"{dag_ms:.2f} ms a build ({', '.join(f'{x:.2f}' for x in dag_rounds)}"
          f"; CUDA events); all {n_items} items = build_dataset, word for word "
          f"(the plain version: {plain_ms['dag'] / 1e3:.2f} s, "
          f"{ETHASH_DAG_SLICE} items a slice, host clock); 8 items = "
          "calc_dataset_item", flush=True)
    probe, probe_text = l2_probe_rate(dev, stream)
    print(f"   {probe_text}; B7a: {l2_share('dag', n_items, dag_ms, probe)}",
          flush=True)

    # -- 35. B7 against the plain version ---------------------------------------
    from otedama_tpu_torch.runtime.search import (ETHASH_CUDA_BATCH,
                                                  ETHASH_LIGHT_LANES)

    phase("35 B7b (full at 2^20 lanes and the engine's 2^26, light at 2^12, "
          "2^14, the engine's 2^18 and counts 0, 1 and 37) and B7c (counts "
          "0, 1, 3, 129, 1,023 and 1,024, 64-bit nonces, k = 16 and 256) "
          "against ethash_torch on the card, buffer for buffer")
    hh = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()

    def dense_limbs(base, lanes, full):
        src = dag if full else cache_p
        pf = et.full_page_fn(src) if full else et.light_page_fn(src)
        s = et.seed_words(et.hash_words(hh).to(dev),
                          et.window_nonces(base, lanes, dev))
        _, res = et.hashimoto_words(full_size, pf, s)
        return torch.stack(et.result_limbs(res), 1).cpu().numpy()

    def search_case(name, full, base, lanes, last, limbs, k=16, chunk=None):
        src = dag if full else cache_d
        a = host_buf(ec.ethash_search(full_size, src, hh, base, last, limbs,
                                      batch=lanes, k=k, full=full))
        t0 = time.monotonic()
        b = host_buf(et.winner_step(full_size, dag if full else cache_p, hh,
                                    base, lanes, limbs, last + 1, k,
                                    full=full, chunk=chunk))
        plain_s = time.monotonic() - t0
        n = equal("full" if full else "light", name, a, b, k)
        print(f"   {'full' if full else 'light'} {name}: {lanes} lanes from "
              f"{base:#x}, last {last}, k={k}, n={n}"
              f"{' (overflow: count and min)' if n > k else ''}, min_h0="
              f"{b[2 * k + 2]:#010x} equal", flush=True)
        return b, plain_s

    for full, lanes in ((True, 1 << 20), (False, 1 << 12)):
        base = int(rng.integers(1 << 32))
        lim = dense_limbs(base, lanes, full)
        order = np.lexsort(lim.T[::-1])
        best = tgt.limbs_to_target(lim[order[0]])
        b, plain_s = search_case("one winner (target = the best lane's "
                                 "result)", full, base, lanes, lanes - 1,
                                 ethash_limbs_of(best))
        check(int(b[32]) == 1 and int(b[0]) == int(order[0]),
              f"one winner: {b.tolist()}")
        b, _ = search_case("overflow at k = 16", full, base, lanes, lanes - 1,
                           ethash_limbs_of(tgt.limbs_to_target(lim[order[63]])))
        check(int(b[32]) == 64, f"overflow: n = {b[32]}")
        search_case("a count ending mid-block", full, base, lanes, lanes - 38,
                    ethash_limbs_of(tgt.limbs_to_target(lim[order[8]])))
        search_case("a window past 2^32", full, (1 << 32) - lanes // 2, lanes,
                    lanes - 1, ethash_limbs_of((1 << 256) // lanes * 8))
    # B7b light at the edge counts: no lane, one (a quad with one live
    # pair), 37 (a quad half past the count) in a 64-lane window
    for count, top in ((0, (1 << 256) - 1), (1, (1 << 256) - 1),
                       (37, (1 << 256) // 4)):
        b, _ = search_case(f"count {count}", False, int(rng.integers(1 << 32)),
                           64, count - 1, ethash_limbs_of(top))
        check(int(b[32]) <= count, f"count {count}: n = {b[32]}")
    # the engine's own launches (phase 37): the full tier's ETHASH_CUDA_BATCH
    # lanes, the light tier's ETHASH_LIGHT_LANES (and 2^14, phase 36's other
    # light time), ~8 winners each (k = 32: every word), the window past
    # 2^32; the plain full tier hashed ETHASH_PLAIN_SLICE lanes at a time
    for full, lanes in ((True, ETHASH_CUDA_BATCH), (False, 1 << 14),
                        (False, ETHASH_LIGHT_LANES)):
        b, plain_s = search_case(
            "~8 winners", full, (1 << 32) - lanes // 3, lanes, lanes - 1,
            ethash_limbs_of((1 << 256) // lanes * 8), k=32,
            chunk=ETHASH_PLAIN_SLICE if full else None)
        check(1 <= int(b[64]) <= 32, f"{lanes} lanes: n = {b[64]}")
        if lanes != 1 << 14:
            plain_ms["full" if full else "light"] = plain_s * 1e3
        print(f"   the plain version at {lanes} lanes: {plain_s:.2f} s "
              "(host clock)", flush=True)
    # B7c: 1,024 shares, each its own header hash and 64-bit nonce (rows 0-2
    # at 2^64 - 1, 2^63 and 2^32), one in ~9 forged. Each count runs on a
    # row set of its own, short for the small counts, whose rows past the
    # count are all forged: a kernel that judged them would show
    n = 1024
    hhs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    nonces[:3] = [(1 << 64) - 1, 1 << 63, 1 << 32]
    res = et.hashimoto_dense(full_size, cache_p, hhs, nonces)[1]
    vals = limbs_of_digests(res[:, ::-1].tobytes())
    forged = rng.random(n) < 1 / 9
    limbs = np.where(forged[:, None], limbs_step(vals, -1), vals)
    rows_h, rows_n = ec.share_rows(hhs, nonces)
    nonces_d = torch.from_numpy(nonces.astype(np.int64)).to(dev)

    def on_card(*parts):
        return [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
                for x in parts]

    for count in B7C_COUNTS:
        m = min(n, count + 3)
        lim = np.where((np.arange(m) < count)[:, None], limbs[:m],
                       limbs_step(vals[:m], -1))
        vrows = on_card(rows_h[:m], rows_n[:m], lim)
        want = np.nonzero(forged[:count])[0].tolist()
        for k in (16, 256):
            a = host_buf(ec.ethash_verify(full_size, cache_d, *vrows, count,
                                          k=k))
            t0 = time.monotonic()
            b = host_buf(et.verify_step(full_size, cache_p, vrows[0],
                                        nonces_d[:m], vrows[2], count, k))
            if count == n and k == 256:
                plain_ms["verify"] = (time.monotonic() - t0) * 1e3
            got_n = equal("verify", f"verify count {count} k={k}", a, b, k)
            check(got_n == len(want), f"verify count {count}: {got_n} "
                  f"failures, {len(want)} forged")
            if got_n <= k:
                check(b[:got_n].tolist() == want,
                      f"verify count {count}: failures != the forged rows")
            print(f"   B7c, count {count} of {m} rows (rows past it forged), "
                  f"k={k}: {got_n} failures = the forged rows"
                  f"{' (overflow: count and min)' if got_n > k else ''}, "
                  f"min_h0={b[2 * k + 2]:#010x}; equal", flush=True)
    on = on_card(rows_h, rows_n, limbs)
    # 16 dense results: light and full plain, and the host oracle
    dn = rng.integers(0, 1 << 32, 16, dtype=np.uint64)
    lm, lr = et.hashimoto_dense(full_size, cache_p, hh, dn)
    fm, fr = et.hashimoto_dense(full_size, dag, hh, dn, full=True)
    hm, hr = eth.hashimoto_light_batch(full_size, cache, hh, dn)
    check(np.array_equal(lm, fm) and np.array_equal(lm, hm)
          and np.array_equal(lr, fr) and np.array_equal(lr, hr),
          "dense results differ across light, full and the host oracle")
    print("   16 dense results (mix digests and results) equal across the "
          "light and full plain versions and hashimoto_light_batch", flush=True)

    # -- 36. times ------------------------------------------------------------------
    phase("36 B7 times beside the bound")
    counted = counts.result()
    print(f"   B7 from the SASS of its counting build ({counted['seconds']:.1f}"
          f" s; instructions: all, ALU pipe, FMA pipe, shuffles): an item "
          f"of the quad core {counted['item']}; a full-tier hash "
          f"{counted['full']}; a thread of B7b light and B7c (half a hash) "
          f"with one access {counted['light1']} and with two "
          f"{counted['light2']}; the one-thread core's item, a constant: "
          f"{ec.ONE_THREAD_ITEM} ALU and FMA", flush=True)
    for kind, what in (("dag", "an item"), ("light", "a light hash (B7b "
                                                     "light, B7c)")):
        ops, whose = ec.lane_ops(counted, kind)
        print(f"   the bound of {what}: {ops} integer instructions, from "
              f"{whose}", flush=True)
    out = torch.empty(winner_buffer_words(16), dtype=torch.int32, device=dev)

    def bound(kind, lanes):
        terms = ec.bound_ms(kind, lanes, counted, sms=sms, clock_mhz=clock_mhz,
                            rows=rows, full_size=full_size,
                            hbm_bytes_per_s=HBM_BYTES_PER_S)
        by = max(terms, key=terms.get)
        return terms[by], by, ", ".join(f"{k} {v:.4f} ms" for k, v in terms.items())

    times = {}
    with Sampler() as sampled:
        for full, lanes in ((True, 1 << 22), (True, ETHASH_CUDA_BATCH),
                            (True, 1 << 24), (False, 1 << 14),
                            (False, ETHASH_LIGHT_LANES)):
            src = dag if full else cache_d
            ms, per = median_ms(lambda: ec.ethash_search(
                full_size, src, hh, 0, lanes - 1, ethash_limbs_of(0),
                batch=lanes, k=16, full=full, stream=stream, out=out),
                stream, reps=3 if full else 1)
            times[(full, lanes)] = ms
            b_ms, by, text = bound("full" if full else "light", lanes)
            print(f"   B7b {'full' if full else 'light'} {lanes} lanes: "
                  f"{ms:.3f} ms ({', '.join(f'{t:.3f}' for t in per)}) = "
                  f"{lanes / ms / 1e3:.2f} MH/s; bound {b_ms:.3f} ms by {by} "
                  f"({b_ms / ms:.1%} of it; {text})"
                  + ("" if full else f"; {l2_share('light', lanes, ms, probe)}"),
                  flush=True)
        vout = torch.empty(winner_buffer_words(256), dtype=torch.int32, device=dev)
        verify_ms, per = median_ms(lambda: ec.ethash_verify(
            full_size, cache_d, *on, n, k=256, stream=stream, out=vout),
            stream, reps=3)
        one_ms, one_per = median_ms(lambda: ec.ethash_verify(
            full_size, cache_d, *on, 1, k=256, stream=stream, out=vout),
            stream, reps=3)
        # B7c's floor: a share's 16,384 dependent row reads, timed as one
        # warp's chains of that many (and twice as many: their difference
        # is the steps alone, without the launch)
        chase = {}
        for steps in (ec.CHASE_STEPS, 2 * ec.CHASE_STEPS):
            chase[steps] = median_ms(lambda: ec.chase_probe(
                cache_d, steps, stream=stream, sink=vout), stream, reps=3)
    v_bound, v_by, v_text = bound("verify", n)
    chase_ms = chase[ec.CHASE_STEPS][0]
    step_ns = (chase[2 * ec.CHASE_STEPS][0] - chase_ms) / ec.CHASE_STEPS * 1e6
    floor_ms = ec.CHASE_STEPS * step_ns / 1e6
    b7c_floor = (f"a share's floor {floor_ms:.3f} ms: {ec.CHASE_STEPS} "
                 f"dependent cache-row reads at {step_ns:.1f} ns (the chase "
                 f"probe, {chase_ms:.3f} ms a launch of {ec.CHASE_STEPS} "
                 f"steps, {chase[2 * ec.CHASE_STEPS][0]:.3f} of "
                 f"{2 * ec.CHASE_STEPS}), before its keccaks; one share a "
                 f"call {one_ms:.3f} ms")
    print(f"   B7c, {n} shares a call: {verify_ms:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in per)}); bound {v_bound:.4f} ms by "
          f"{v_by} ({v_bound / verify_ms:.1%} of it; {v_text}): {n} shares, "
          f"two threads each, fill {2 * n // ec.THREADS} blocks of {sms} SMs, "
          f"so a call lasts about one share's dependent chain; one share a "
          f"call {one_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in one_per)}; "
          f"the {n}-share call {verify_ms / one_ms:.3f}x it); {b7c_floor}; "
          f"the {n}-share call at {floor_ms / verify_ms:.1%} of that floor",
          flush=True)
    d_bound, d_by, d_text = bound("dag", n_items)
    print(f"   B7a: {dag_ms:.2f} ms a build; bound {d_bound:.3f} ms by {d_by} "
          f"({d_bound / dag_ms:.1%} of it; {d_text}); "
          f"{l2_share('dag', n_items, dag_ms, probe)}", flush=True)
    print(f"   {sampled.summary()}; {card}", flush=True)
    full_ms = times[(True, ETHASH_CUDA_BATCH)]
    light_ms = times[(False, ETHASH_LIGHT_LANES)]
    f_bound, f_by, _ = bound("full", ETHASH_CUDA_BATCH)
    l_bound, l_by, _ = bound("light", ETHASH_LIGHT_LANES)
    src = "otedama_tpu_torch/kernels/csrc/ethash.cu"
    records = {
        "ethash_dag": {
            "name": "ethash_dag", "route": "cuda", "source": src,
            "replaces": "otedama_tpu/kernels/ethash.py:611",
            "launches": 0, "max_abs_err": max_err["dag"], "ms": dag_ms,
            "plain_ms": plain_ms["dag"], "bound_ms": d_bound,
            "bound_by": d_by, "library_ms": None,
            "path": f"epoch 0's DAG, {n_items} items, all compared (phase "
                    "34); a launch is one wrapper call of one kernel launch; "
                    f"the bound's count from {ec.lane_ops(counted, 'dag')[1]}; "
                    + l2_share("dag", n_items, dag_ms, probe)},
        "ethash_search_full": {
            "name": "ethash_search_full", "route": "cuda", "source": src,
            "replaces": "otedama_tpu/kernels/ethash.py:501",
            "launches": 0, "max_abs_err": max_err["full"], "ms": full_ms,
            "plain_ms": plain_ms["full"], "bound_ms": f_bound,
            "bound_by": f_by, "library_ms": None,
            "path": f"B7b full at the engine's {ETHASH_CUDA_BATCH} lanes "
                    "(ms, plain, bound); a launch is one wrapper call of 2 + "
                    "ceil(lanes / 2^30) kernel launches (3 here)"},
        "ethash_search_light": {
            "name": "ethash_search_light", "route": "cuda", "source": src,
            "replaces": "otedama_tpu/kernels/ethash.py:501",
            "launches": 0, "max_abs_err": max_err["light"], "ms": light_ms,
            "plain_ms": plain_ms["light"], "bound_ms": l_bound,
            "bound_by": l_by, "library_ms": None,
            "path": f"B7b light at the engine's {ETHASH_LIGHT_LANES} lanes "
                    "(ms, plain, bound); a launch is one wrapper call of 2 + "
                    "ceil(lanes / 2^30) kernel launches (3 here); the "
                    f"bound's count from {ec.lane_ops(counted, 'light')[1]}; "
                    + l2_share("light", ETHASH_LIGHT_LANES, light_ms, probe)},
        "ethash_verify": {
            "name": "ethash_verify", "route": "cuda", "source": src,
            "replaces": "otedama_tpu/kernels/ethash.py:542",
            "launches": 0, "max_abs_err": max_err["verify"], "ms": verify_ms,
            "plain_ms": plain_ms["verify"], "bound_ms": v_bound,
            "bound_by": v_by, "library_ms": None,
            "path": "B7c, 1,024 shares a call; a launch is one wrapper "
                    "call of 2 + ceil(rows / 2^30) kernel launches (3 here); "
                    f"the bound's count from {ec.lane_ops(counted, 'verify')[1]}; "
                    + b7c_floor},
    }
    state = {"cache": cache, "full_size": full_size,
             "rate": ETHASH_CUDA_BATCH / times[(True, ETHASH_CUDA_BATCH)] * 1e3}
    del dag, cache_d, cache_p
    torch.cuda.empty_cache()
    return {"records": records, "state": state}


class EpochSwitchClock:
    """Phase 37's breakdown of an epoch switch: from ``start()`` (the
    template's move) the times, on the host's clock, at which the new
    epoch's job reaches the backend and its cache is ready, and for each B7
    call enqueued after it (B7a, B7b light and full of any epoch, told
    apart by their ``full_size``) its enqueue, and the start and end of its
    work on the card by CUDA events recorded around it on its stream,
    against an event recorded at ``start()`` on an idle stream. It wraps
    the public wrappers ``ethash_cuda.build_dag`` and ``ethash_search``
    (each still counts its launch) and the backend's ``_tier_for`` and
    ``_light_tier``, and puts them back in ``stop()``."""

    def __init__(self, dev, backend, epoch: int):
        import torch

        from otedama_tpu_torch.kernels import ethash as eth
        from otedama_tpu_torch.kernels import ethash_cuda as ec

        self.torch, self.ec, self.eth = torch, ec, eth
        self.dev, self.backend, self.epoch = dev, backend, epoch
        self.full_size = eth.dataset_size(epoch * eth.EPOCH_LENGTH)
        self.stamps: dict[str, float] = {}
        self.calls: list[tuple] = []      # (what, enqueued s, e0, e1)
        self.lock = threading.Lock()
        self.t0 = None

    def _timed(self, what, stream, fn):
        ev = self.torch.cuda.Event
        e0, e1 = ev(enable_timing=True), ev(enable_timing=True)
        t = time.monotonic() - self.t0
        e0.record(stream)
        out = fn()
        e1.record(stream)
        with self.lock:
            self.calls.append((what, t, e0, e1))
        return out

    def start(self) -> None:
        ec, eth, backend = self.ec, self.eth, self.backend
        self.saved = (ec.build_dag, ec.ethash_search)
        build_dag, search = self.saved
        tier_for = backend._tier_for
        light_tier = backend._light_tier
        sizes = {eth.dataset_size(e * eth.EPOCH_LENGTH): e
                 for e in range(self.epoch + 1)}

        def stamp(key):
            with self.lock:
                self.stamps.setdefault(key, time.monotonic() - self.t0)

        def timed_build_dag(cache, full_size, *, stream=None, out=None):
            return self._timed(
                f"B7a epoch {sizes.get(full_size)}", stream,
                lambda: build_dag(cache, full_size, stream=stream, out=out))

        def timed_search(full_size, source, *args, full, stream=None, **kw):
            return self._timed(
                f"B7b {'full' if full else 'light'} epoch "
                f"{sizes.get(full_size)}", stream,
                lambda: search(full_size, source, *args, full=full,
                               stream=stream, **kw))

        def timed_tier_for(jc):
            if jc.block_number // eth.EPOCH_LENGTH == self.epoch:
                stamp("job at the backend")
            return tier_for(jc)

        def timed_light_tier(epoch):
            tier = light_tier(epoch)
            if epoch == self.epoch:
                stamp("cache ready")
            return tier

        self.stream = self.torch.cuda.Stream(self.dev)
        self.ref = self.torch.cuda.Event(enable_timing=True)
        self.t0 = time.monotonic()
        self.ref.record(self.stream)
        ec.build_dag, ec.ethash_search = timed_build_dag, timed_search
        backend._tier_for, backend._light_tier = timed_tier_for, timed_light_tier

    def stop(self) -> None:
        if self.t0 is not None and "_tier_for" in vars(self.backend):
            self.ec.build_dag, self.ec.ethash_search = self.saved
            del self.backend._tier_for, self.backend._light_tier

    def report(self, first_share: float, full_tier: float) -> str:
        """The breakdown as text (seconds from the template's move; the
        card's start-end of each call and its ms)."""
        self.torch.cuda.synchronize(self.dev)
        rows = []
        for what, t, e0, e1 in self.calls:
            a = self.ref.elapsed_time(e0) / 1e3
            b = self.ref.elapsed_time(e1) / 1e3
            rows.append((what, t, a, b, e0.elapsed_time(e1)))
        text = [f"{k} {v:.3f} s" for k, v in sorted(self.stamps.items(),
                                                   key=lambda kv: kv[1])]
        new = f"epoch {self.epoch}"
        old = [r for r in rows if not r[0].endswith(new)]
        if old:
            text.append(f"{len(old)} calls of earlier epochs enqueued after "
                        f"the move, the last ending on the card at "
                        f"{max(r[3] for r in old):.3f} s")
        for what in (f"B7a {new}", f"B7b light {new}", f"B7b full {new}"):
            mine = [r for r in rows if r[0] == what]
            if what.startswith("B7b full"):
                mine = mine[:3]      # the first group
            text += [f"{what} #{i + 1} enqueued {t:.3f} s, on the card "
                     f"{a:.3f}-{b:.3f} s ({ms:.2f} ms)"
                     for i, (_, t, a, b, ms) in enumerate(mine)]
        text.append(f"the full tier {full_tier:.3f} s; the first share "
                    f"{first_share:.3f} s")
        return "; ".join(text)


def ethash_solo_phase(dev, card: str, b7_rate: float) -> dict:
    """Phase 37: solo ethash through ``Application`` at epoch 0, then
    across two epoch boundaries. ``b7_rate``: B7b full's H/s at the
    engine's launch (phase 36). Returns the launches of each B7 kernel."""
    import numpy as np
    import torch

    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig
    from otedama_tpu_torch.engine.jobs import header_from_share
    from otedama_tpu_torch.kernels import ethash as eth
    from otedama_tpu_torch.kernels import ethash_cuda as ec
    from otedama_tpu_torch.kernels import ethash_torch as et
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.kernels.card import Sampler
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.runtime.search import (ETHASH_CUDA_BATCH,
                                                  ETHASH_MAX_FULL_TIERS)
    from otedama_tpu_torch.utils import pow_host

    chain_target = (1 << 256) // int(b7_rate / 2.0)     # ~2 shares a second
    nbits = tgt.target_to_bits(chain_target)
    chain_target = tgt.bits_to_target(nbits)
    phase(f"37 main path: solo ethash Application on the card, mock chain "
          f"nbits {nbits:#010x} (about 2 shares/s): epoch 0 light -> full, "
          f"{ETHASH_SOLO_S:.0f} s steady, then blocks 29,990, 30,005 and "
          "60,005")
    cfg = AppConfig()
    cfg.mining.algorithm = "ethash"
    cfg.mining.device = "cuda"
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.2
    chain = MockChainClient(nbits=nbits)
    app = Application(cfg, chain=chain)
    shares, outcomes = [], []
    on_share, submit = app._on_share, chain.submit_block

    async def record_share(share):
        shares.append((time.monotonic(), share,
                       app.worksource.get_job(share.job_id)))
        await on_share(share)

    async def record_submit(header):
        outcome = await submit(header)
        outcomes.append((header, outcome))
        return outcome

    app._on_share = record_share
    chain.submit_block = record_submit
    marks, resident = {}, []

    async def until_(cond, timeout, what):
        t_end = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < t_end, f"phase 37: {what} not within "
                  f"{timeout:.0f} s")
            await asyncio.sleep(0.01)
        return time.monotonic()

    async def watch_tiers(backend):
        while True:
            resident.append(len(backend.snapshot()["full_epochs"]))
            await asyncio.sleep(0.05)

    def first_share_of(epoch, after):
        return next((t for t, s, j in shares if t >= after
                     and j.block_number // eth.EPOCH_LENGTH == epoch), None)

    async def run37():
        await app.start()
        try:
            t_end = time.monotonic() + MAIN_PATH_BOUND_S
            while app.engine.state.value != "running":
                check(time.monotonic() < t_end, "ethash engine never started")
                check(not any(t.done() and not t.cancelled() and t.exception()
                              for t in app._tasks),
                      "a background task failed before the engine started")
                await asyncio.sleep(0.05)
            t_start = time.monotonic()
            backend = next(iter(app.engine.backends.values()))
            tiers = asyncio.get_running_loop().create_task(watch_tiers(backend))
            watch.start(app.engine)
            marks["full0"] = await until_(
                lambda: 0 in backend.snapshot()["full_epochs"], 60.0,
                "epoch 0's full tier") - t_start
            # the light calls dispatched before the upgrade drain first
            await asyncio.sleep(2.0)
            h0, t0 = app.engine.stats.hashes, time.monotonic()
            with Sampler(1.0) as sampled:
                await asyncio.sleep(ETHASH_SOLO_S)
            h1, t1 = app.engine.stats.hashes, time.monotonic()
            marks["window"] = (h1 - h0, t1 - t0, sampled.summary(),
                               watch.between(t0, t1))
            # epoch 1 prefetched from block 29,990, then mined from 30,005
            chain.height = 29_989
            tp = time.monotonic()
            marks["prefetch1"] = await until_(
                lambda: 1 in backend.snapshot()["full_epochs"], 60.0,
                "epoch 1's prefetched DAG") - tp
            chain.height = 30_004
            t1s = time.monotonic()
            await until_(lambda: first_share_of(1, t1s) is not None, 60.0,
                         "a share of epoch 1")
            marks["share1"] = first_share_of(1, t1s) - t1s
            marks["calls1"] = dict(backend.snapshot())
            torch.cuda.synchronize(dev)
            mem_before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            # epoch 2, not prefetched: light, then full; epoch 0 evicted;
            # each step of the switch timed
            clock = marks["clock"] = EpochSwitchClock(dev, backend, 2)
            clock.start()
            chain.height = 60_004
            t2s = time.monotonic()
            # both watched at once: the full tier may land before the share
            _, t_full = await asyncio.gather(
                until_(lambda: first_share_of(2, t2s) is not None, 60.0,
                       "a share of epoch 2"),
                until_(lambda: 2 in backend.snapshot()["full_epochs"], 60.0,
                       "epoch 2's full tier"))
            marks["share2"] = first_share_of(2, t2s) - t2s
            marks["full2"] = t_full - t2s
            await asyncio.sleep(1.0)
            clock.stop()
            marks["switch2"] = clock.report(
                first_share_of(2, t2s) - clock.t0,
                marks["full2"] + t2s - clock.t0)
            torch.cuda.synchronize(dev)
            marks["memory"] = (mem_before, torch.cuda.memory_allocated(dev),
                               torch.cuda.max_memory_allocated(dev))
            marks["snapshot"] = backend.snapshot()
            watch.stop()
            tiers.cancel()
            return backend
        finally:
            if "clock" in marks:
                marks["clock"].stop()
            await app.stop()

    counters = {"dag": ec.dag_launches, "full": ec.search_full_launches,
                "light": ec.search_light_launches}
    for c in counters.values():
        c.reset()
    et.calls.reset()
    watch = HashWatch()
    mem_idle = torch.cuda.memory_allocated(dev)
    backend = asyncio.run(run37())
    launches = {k: c.value for k, c in counters.items()}
    torch.cuda.synchronize(dev)
    mem_after = torch.cuda.memory_allocated(dev)
    check(backend.name == "ethash-managed", f"the engine ran {backend.name}")
    check(launches["dag"] >= 3 and launches["full"] > 0
          and launches["light"] > 0 and et.calls.value == 0,
          f"B7 launches {launches}, plain-version calls {et.calls.value}")
    snap = marks["snapshot"]
    check(snap["build_failures"] == 0, f"DAG builds failed: {snap}")
    check(snap["full_epochs"] == [1, 2] and snap["evictions"] >= 1,
          f"epochs after the switch: {snap}")
    check(max(resident) <= ETHASH_MAX_FULL_TIERS,
          f"{max(resident)} DAGs resident, ETHASH_MAX_FULL_TIERS "
          f"{ETHASH_MAX_FULL_TIERS}")
    before, after, peak = marks["memory"]
    dag_bytes = eth.dataset_size(60_000)
    check(after <= before + (64 << 20),
          f"memory after epoch 0's eviction {after} B, before epoch 2 "
          f"{before} B")
    check(mem_after <= mem_idle + (64 << 20),
          f"after the app's stop {mem_after} B on the card, {mem_idle} B "
          "before it started")
    # every share through the host oracle, an epoch a pass
    by_epoch = {}
    for _, share, job in shares:
        by_epoch.setdefault(job.block_number, []).append((share, job))
    for bn, rows in by_epoch.items():
        headers = [header_from_share(j, s.extranonce2, s.ntime, s.nonce_word)
                   for s, j in rows]
        for (s, j), d in zip(rows, pow_host.pow_digests(headers, "ethash", bn)):
            check(d == s.digest and int.from_bytes(d, "little") <= j.share_target,
                  f"ethash share {s.nonce_word:#x} at block {bn} fails the "
                  "host oracle")
    refused = sum(not o.accepted for _, o in outcomes)
    for header, outcome in outcomes:
        check(outcome.accepted == (int.from_bytes(hashlib.sha256(
            hashlib.sha256(header).digest()).digest(), "little")
            <= chain_target), "the mock chain's verdict != sha256d's")
    hashes, seconds, clocks, (steady, steady_text) = marks["window"]
    check(steady >= SOLO_ETHASH_MIN_SHARE * b7_rate,
          f"solo ethash steady {steady / 1e6:.2f} MH/s = {steady / b7_rate:.1%}"
          f" of B7b full's {b7_rate / 1e6:.2f} MH/s")
    print(f"   epoch 0: the engine's start to the full tier "
          f"{marks['full0']:.2f} s (the cache by the compiled generator, "
          f"B7b light meanwhile, B7a in the background); over "
          f"{ETHASH_SOLO_S:.0f} s on the full tier {hashes} hashes in "
          f"{seconds:.2f} s = {hashes / seconds / 1e6:.2f} MH/s; "
          f"{steady_text}; = {steady / b7_rate:.1%} of B7b full's "
          f"{b7_rate / 1e6:.2f} MH/s at {ETHASH_CUDA_BATCH} lanes; {clocks}",
          flush=True)
    print(f"   epoch 1: prefetched (cache and DAG) {marks['prefetch1']:.2f} s "
          f"after the job at block 29,990; its first share "
          f"{marks['share1']:.2f} s after the template moved to 30,005, on "
          f"its full tier (calls then: full {marks['calls1']['full_calls']}, "
          f"light {marks['calls1']['light_calls']}); epoch 2 (not "
          f"prefetched): first share {marks['share2']:.2f} s, full tier "
          f"{marks['full2']:.2f} s after block 60,005; epoch 0 evicted "
          f"({snap['evictions']} evictions, resident DAGs at most "
          f"{max(resident)} of {ETHASH_MAX_FULL_TIERS}); memory_allocated "
          f"{before / 2**30:.3f} GiB before epoch 2, {after / 2**30:.3f} GiB "
          f"after its upgrade and the eviction (peak {peak / 2**30:.3f} GiB, "
          f"a DAG {dag_bytes / 2**30:.3f} GiB), {mem_after / 2**30:.3f} GiB "
          f"after the app's stop ({mem_idle / 2**30:.3f} before); "
          f"build_failures 0", flush=True)
    print(f"   epoch 2's switch, from the template's move to block 60,005 "
          f"(host clock; the card's by CUDA events): {marks['switch2']}",
          flush=True)
    print(f"   {len(shares)} shares over {len(by_epoch)} heights, each "
          f"through the host oracle at or under its target; "
          f"{len(outcomes)} block candidates, {refused} refused by the mock "
          f"chain (it checks blocks by sha256d); launches: B7a "
          f"{launches['dag']}, B7b full {launches['full']}, B7b light "
          f"{launches['light']}; plain-version calls 0; {card}", flush=True)
    return launches


def ethash_ledger_phase(dev, card: str, cache) -> int:
    """Phase 38: ethash shares at the pool ledger through B7c. Returns its
    launches in the counted run."""
    import numpy as np
    import torch

    from otedama_tpu_torch.db import connect_database
    from otedama_tpu_torch.kernels import ethash as eth
    from otedama_tpu_torch.kernels import ethash_cuda as ec
    from otedama_tpu_torch.kernels import ethash_torch as et
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.pool.manager import PoolManager
    from otedama_tpu_torch.runtime.validate import ShareCheck, \
        ValidationBackend, dispatch_executor
    from otedama_tpu_torch.stratum.server import AcceptedShare

    phase(f"38 main path: {ETHASH_FLUSHES} ethash flushes of 1,024 (epoch 0) "
          "through PoolManager.on_share_batch -> B7c")
    rng = np.random.default_rng(SEED + 17)
    full_size, block = eth.dataset_size(0), 101
    total = ETHASH_FLUSHES * 1024
    headers = rng.integers(0, 256, (total, 80), dtype=np.uint8)
    t0 = time.monotonic()
    hh, nonces = eth.share_fields(headers)
    res = ethash_oracle(full_size, cache, hh, nonces)
    print(f"   {total} shares hashed by the host oracle (hashimoto_light_batch"
          f", 1,024 a spawned process) in {time.monotonic() - t0:.1f} s",
          flush=True)
    values = [int.from_bytes(r.tobytes(), "big") for r in res]
    byz = rng.random(total) < 1 / 256

    def byzantine_difficulty(v: int) -> float:
        s = (tgt.DIFF1_TARGET << 32) // v + 1
        while (tgt.DIFF1_TARGET << 32) // s >= v:
            s += 1
        return s / (1 << 32)

    flushes = []
    for f in range(ETHASH_FLUSHES):
        batch, honest = [], []
        for i in range(1024 * f, 1024 * (f + 1)):
            v = values[i]
            diff = (byzantine_difficulty(v) if byz[i]
                    else tgt.target_to_difficulty(v) * 0.5)
            honest.append(v <= tgt.difficulty_to_target(diff))
            batch.append(AcceptedShare(
                session_id=i, worker_user=f"e.{i % 512}", job_id="eth-ledger",
                difficulty=diff, actual_difficulty=diff,
                digest=res[i][::-1].tobytes(), header=headers[i].tobytes(),
                extranonce2=struct.pack(">I", i), ntime=1_700_000_000,
                nonce_word=int(nonces[i]), is_block=False,
                submitted_at=1_700_000_000.0, algorithm="ethash",
                block_number=block))
        flushes.append((batch, honest))
    pm = PoolManager(connect_database(":memory:"), MockChainClient())
    pm.validator = ValidationBackend(min_batch=128, tripwire_rate=0.05,
                                     seed=SEED)
    ec.verify_launches.reset()
    et.calls.reset()

    async def run38():
        outs, secs = [], []
        for batch, _ in flushes:
            t = time.monotonic()
            outs.append(await pm.on_share_batch(batch))
            secs.append(time.monotonic() - t)
        return outs, secs

    outs, secs = asyncio.run(run38())
    launches, plain = ec.verify_launches.value, et.calls.value
    snap = pm.validator.snapshot()
    honest_total = 0
    for (batch, honest), outcomes_ in zip(flushes, outs):
        for ok, outcome in zip(honest, outcomes_):
            check(outcome == (("ok", "") if ok
                              else ("err", "share failed validation")),
                  f"ledger outcome {outcome} != the host oracle's verdict {ok}")
        honest_total += sum(honest)
    check(pm.shares.count() == honest_total
          and pm.ledger_stats["shares_ok"] == honest_total
          and pm.ledger_stats["shares_rejected"] == total - honest_total,
          f"books: {pm.shares.count()} shares, {pm.ledger_stats}, honest "
          f"{honest_total}")
    check(snap["device_batches"] == ETHASH_FLUSHES
          and snap["validated_device"] == total and snap["device_errors"] == 0
          and snap["tripwire_mismatches"] == 0 and snap["overflows"] == 0
          and snap["host_batches"] == 0, f"validator snapshot {snap}")
    check(launches == ETHASH_FLUSHES and plain == 0,
          f"B7c launches {launches}, plain calls {plain}")
    rates = sorted(1024 / s for s in secs)
    print(f"   {total} shares in {sum(secs):.2f} s = {total / sum(secs):.0f} "
          f"shares/s; per flush median {rates[len(rates) // 2]:.0f}, min "
          f"{rates[0]:.0f}, max {rates[-1]:.0f}; every outcome = the host "
          f"oracle's; books: {pm.shares.count()} shares = the honest ones, "
          f"{total - honest_total} rejected; tripwire checks "
          f"{snap['tripwire_checks']}, mismatches 0, device errors 0, "
          f"overflows 0; B7c launches {launches}, plain-version calls {plain}",
          flush=True)
    # the validator's dispatches at once, in rounds: every buffer equal to
    # a lone dispatch's, whose failures are the host oracle's
    v = pm.validator
    rows = []
    for batch, honest in flushes:
        checks = [ShareCheck(s.header, tgt.difficulty_to_target(s.difficulty),
                             "ethash", block) for s in batch]
        alone = v._device_buffer("ethash", checks, v.k)
        n = int(alone[2 * v.k])
        check(n == honest.count(False) and alone[:n].tolist()
              == [i for i, ok in enumerate(honest) if not ok],
              "a lone dispatch's failures != the host oracle's")
        rows.append((checks, alone))
    # one buffer against the plain version on the card
    cache_d = et.source_tensor(cache, dev)
    checks = rows[0][0]
    hh0, nn0 = ec.share_rows(hh[:1024], nonces[:1024])
    limbs0 = np.stack([tgt.target_to_limbs(c.target) for c in checks])
    plain_buf = et.verify_step(
        full_size, cache_d, torch.from_numpy(hh0.astype(np.int64)).to(dev),
        torch.from_numpy(nonces[:1024].astype(np.int64)).to(dev),
        torch.from_numpy(limbs0.astype(np.int64)).to(dev), 1024, v.k)
    check(plain_buf.cpu().numpy().view(np.uint32).tolist()
          == rows[0][1].tolist(), "the first flush's B7c buffer != the plain "
          "version's")
    rounds = 2
    for r in range(rounds):
        futures = [dispatch_executor().submit(v._device_buffer, "ethash",
                                              checks, v.k)
                   for checks, _ in rows]
        for i, (f, (_, alone)) in enumerate(zip(futures, rows)):
            check(f.result().tolist() == alone.tolist(),
                  f"concurrent dispatch {i}, round {r}: != the lone one")
    print(f"   {rounds} rounds of {len(rows)} ethash dispatches at once on "
          f"one validator (its dispatch executor's threads, one stream): "
          f"every buffer = a lone dispatch's, whose failures are the host "
          f"oracle's; the first flush's = the plain version's", flush=True)
    del pm
    return launches


def ethash_phases(dev, card: str, clock_mhz: float, counts) -> list[dict]:
    """Phases 34-38 (ethash, kernels B7a-B7c). Returns their records."""
    import torch

    out = ethash_kernel_phases(dev, card, clock_mhz, counts)
    records, state = out["records"], out["state"]
    torch.cuda.empty_cache()
    solo = ethash_solo_phase(dev, card, state["rate"])
    ledger = ethash_ledger_phase(dev, card, state["cache"])
    records["ethash_dag"]["launches"] = solo["dag"]
    records["ethash_dag"]["path"] += (f"; solo ethash across epochs 0, 1 and "
                                      f"2 (phase 37): {solo['dag']} launches")
    records["ethash_search_full"]["launches"] = solo["full"]
    records["ethash_search_full"]["path"] = (
        f"solo ethash Application (phase 37): {solo['full']} launches of "
        f"the full tier; " + records["ethash_search_full"]["path"])
    records["ethash_search_light"]["launches"] = solo["light"]
    records["ethash_search_light"]["path"] = (
        f"solo ethash Application before each epoch's DAG (phase 37): "
        f"{solo['light']} launches; " + records["ethash_search_light"]["path"])
    records["ethash_verify"]["launches"] = ledger
    records["ethash_verify"]["path"] = (
        f"pool ledger on_share_batch, ethash flushes of 1,024 (phase 38): "
        f"{ledger} launches; " + records["ethash_verify"]["path"])
    return list(records.values())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run "
              "needs a CUDA card", file=sys.stderr)
        return 2

    import numpy as np

    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig
    from otedama_tpu_torch.kernels import cuda_build
    from otedama_tpu_torch.kernels import ethash as eth
    from otedama_tpu_torch.kernels import ethash_cuda as ec
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.kernels import x11_cuda as xc
    from otedama_tpu_torch.kernels.card import Sampler
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.runtime.search import CudaBackend, JobConstants

    dev = torch.device("cuda", 0)
    k = sc.K_WINNERS
    rng = np.random.default_rng(SEED)

    def kernel_buf(jw, batch, kk=k):
        out = sc.sha256d_search(jw, batch=batch, k=kk, device=dev)
        torch.cuda.synchronize(dev)
        return out.cpu().numpy().view(np.uint32)

    def plain_buf(jw, batch, kk=k, chunk=1 << 22):
        out = st.sha256d_search_buffer(jw, batch=batch, k=kk, device=dev,
                                       chunk=chunk)
        torch.cuda.synchronize(dev)
        return out.cpu().numpy().view(np.uint32)

    def random_job_words(base, count, limbs):
        ms = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
        tail = rng.integers(0, 1 << 32, size=3, dtype=np.uint64)
        return sc.pack_job_words(ms, tail, base, np.asarray(limbs, np.uint32),
                                 count=count)

    max_abs_err = 0

    def compare(name, jw, batch, kk=k):
        """Kernel buffer against the plain buffer: every word when the table
        did not overflow, else the count and the min top limb."""
        nonlocal max_abs_err
        a = kernel_buf(jw, batch, kk)
        b = plain_buf(jw, batch, kk)
        n = int(b[2 * kk])
        if n <= kk:
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            check(not diff.any(), f"{name}: kernel buffer != plain buffer\n"
                  f"kernel {a.tolist()}\nplain  {b.tolist()}")
        else:
            for i in (2 * kk, 2 * kk + 2):
                check(a[i] == b[i], f"{name}: word {i} kernel {a[i]} != "
                      f"plain {b[i]} (overflowed table)")
            diff = np.abs(a[2 * kk:].astype(np.int64) - b[2 * kk:].astype(np.int64))
        max_abs_err = max(max_abs_err, int(diff.max()))
        print(f"   {name}: {batch} lanes, n={n}, min_h0={b[2 * kk + 2]:#010x} "
              "equal", flush=True)
        return b

    # -- 1. card ----------------------------------------------------------
    phase("1 card")
    card = smi("name,power.limit")
    print(card, flush=True)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(dev)
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {props.multi_processor_count} "
          f"SMs, max SM clock {clock_mhz:.0f} MHz", flush=True)
    # B6's counting build (phase 33's bound) compiles at a low priority
    # behind the phases that follow; two of its twelve builds take minutes
    counting = BACKGROUND.submit(xc.chain_instructions)
    # B7's counting build (phase 36's bound), behind B6's
    eth_counting = BACKGROUND.submit(ec.instruction_counts)
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        for f in [pool.submit(load) for load in (sc.load_library,
                                                 scc.load_library,
                                                 xc.load_library,
                                                 ec.load_library,
                                                 eth.load_generator)]:
            f.result()
    print(f"   kernels built and loaded in {time.monotonic() - t0:.1f} s",
          flush=True)
    for info in (sc.build_info, scc.build_info, xc.build_info, ec.build_info,
                 eth.generator_info):
        print(f"   {info['library']}: nvcc {info.get('seconds', 0.0):.1f} s",
              flush=True)
    # B2's work is straight-line code (its loops are the bulk copy's wait
    # and the last block's bookkeeping), so its count is the whole kernel's;
    # B6's loops run the rounds of its stages, so its static count is the
    # whole kernel's and the instructions a lane executes come from its
    # counting build, stage by stage (x11_cuda.chain_instructions, phase 33)
    for info, kernel, loop in ((sc.build_info, "search_kernel", True),
                               (sc.build_info, "verify_kernel", False),
                               (scc.build_info, "romix_kernel", True)):
        for line in cuda_build.kernel_report(info, kernel, loop):
            print(f"   {line}", flush=True)
    b6_resources(dev)
    ethash_resources(dev)

    # -- 2. known answer: the genesis block -----------------------------------
    phase("2 genesis known answer")
    merkle = bytes.fromhex(
        "4a5e1e4baab89f3a32518a88c31bc87f618f76673e2cc77ab2127b7afdeda33b")[::-1]
    h76 = (struct.pack("<I", 1) + bytes(32) + merkle
           + struct.pack("<II", 1231006505, 0x1D00FFFF))
    lane = int.from_bytes(struct.pack("<I", 2083236893), "big")
    window = 1 << 20
    gen = JobConstants.from_header_prefix(h76, tgt.bits_to_target(0x1D00FFFF))
    base = (lane - 333_333) & 0xFFFFFFFF
    wn, _, n, _ = sc.unpack_winner_buffer(
        kernel_buf(gen.job_words(base, window), window), k)
    check(n == 1 and int(wn[0]) == lane,
          f"genesis: expected exactly lane {lane:#x}, got n={n} {wn[:n]}")
    digest = gen.digest_for(int(wn[0]))
    check(digest[::-1].hex() == GENESIS_HASH, f"genesis hash {digest[::-1].hex()}")
    print(f"   lane {lane:#010x} wins; hash {GENESIS_HASH}", flush=True)

    # -- 3. kernel against the plain version --------------------------------
    phase("3 kernel vs plain version")
    full = 0xFFFFFFFF
    few = [1 << 12] + [full] * 7                 # ~4 winners per 2^22 lanes
    jw = random_job_words(int(rng.integers(1 << 32)), None, few)
    compare("few winners", jw, 1 << 22)
    t0 = time.monotonic()
    plain_buf(jw, 1 << 22)
    print(f"   plain version, 2^22 lanes: {(time.monotonic() - t0) * 1e3:.1f} ms",
          flush=True)

    # target exactly at the best lane's hash, and +-1: the 256-bit compare
    # is decided on the low limbs
    span = 1 << 16
    ms = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
    tail = rng.integers(0, 1 << 32, size=3, dtype=np.uint64)
    base = int(rng.integers(1 << 32))
    nonces = (torch.arange(span, device=dev) + base) & 0xFFFFFFFF
    limbs = torch.stack(st.digest_words_to_compare_order(
        st.sha256d_from_midstate([int(x) for x in ms], [int(x) for x in tail],
                                 nonces))).T.cpu().numpy()      # [span, 8]
    best_lane = int(np.lexsort(limbs.T[::-1])[0])
    best_hash = tgt.limbs_to_target(limbs[best_lane])
    for delta, expect in ((0, 1), (-1, 0), (1, 1)):
        jw = sc.pack_job_words(ms, tail, base,
                               tgt.target_to_limbs(best_hash + delta), count=span)
        b = compare(f"target = best lane's hash {delta:+d}", jw, span)
        check(int(b[2 * k]) == expect, f"target hash{delta:+d}: n={b[2 * k]}")
        if expect:
            check(int(b[0]) == (base + best_lane) & 0xFFFFFFFF,
                  "target at hash: wrong lane")

    ragged = (1 << 20) + 77
    compare("ragged count", random_job_words(int(rng.integers(1 << 32)), ragged,
                                             [1 << 14] + [full] * 7), ragged)
    # counts that leave a thread with no nonce, and one past a multiple of
    # the block's tile (one nonce a thread of a block a step)
    for count in (1, 3, sc.SEARCH_BLOCK_NONCES * 1021 + 1):
        compare(f"count {count}", random_job_words(
            int(rng.integers(1 << 32)), count, [1 << 31] + [full] * 7), 1 << 20)
    compare("nonce wraps 2^32", random_job_words((1 << 32) - 1234, None,
                                                 [1 << 15] + [full] * 7), 1 << 18)
    b = compare("count=0 (empty)", random_job_words(5, 0, [full] * 8), 4096)
    check(int(b[2 * k]) == 0 and int(b[2 * k + 2]) == full, "empty window")
    b = compare("table overflow n > k", random_job_words(7, None,
                                                         [1 << 26] + [full] * 7),
                1 << 16)
    check(int(b[2 * k]) > k, "overflow case did not overflow")

    # CudaBackend's bisecting rescan against the plain version's winners
    cb = CudaBackend(dev)
    target = (1 << 26) << 224 | ((1 << 224) - 1)      # ~1/64 of lanes win
    ov = JobConstants.from_header_prefix(bytes(rng.integers(0, 256, 76, dtype=np.uint8)),
                                         target)
    count = 3000
    res = cb.search(ov, 12345, count)
    pb = plain_buf(ov.job_words(12345, count), count, kk=count)
    pwn, _, pn, pmin = sc.unpack_winner_buffer(pb, count)
    check(pn > k, "bisect case did not overflow")
    check([w.nonce_word for w in res.winners] == [int(x) for x in pwn[:pn]],
          "CudaBackend bisect winners != plain winners")
    check(res.best_hash_hi == pmin and res.hashes == count, "bisect telemetry")
    print(f"   CudaBackend bisect: {pn} winners in {count} lanes equal", flush=True)

    # the main path's launch shape: 2^31 lanes, k=16, ~8 winners
    jw = random_job_words(int(rng.integers(1 << 32)), None, [16] + [full] * 7)
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    a = kernel_buf(jw, MAIN_BATCH)
    kernel_main_s = time.monotonic() - t0
    t0 = time.monotonic()
    b = plain_buf(jw, MAIN_BATCH, chunk=1 << 24)
    plain_main_s = time.monotonic() - t0
    check(int(b[2 * k]) <= k, "main-shape case overflowed")
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    check(not diff.any(), f"2^31 launch: kernel {a.tolist()} != plain {b.tolist()}")
    max_abs_err = max(max_abs_err, int(diff.max()))
    print(f"   main shape 2^31 lanes: n={b[2 * k]} equal; kernel "
          f"{kernel_main_s * 1e3:.1f} ms (first call), plain "
          f"{plain_main_s:.1f} s", flush=True)

    # -- 4. main path ---------------------------------------------------------
    phase("4 main path: solo Application on the card, difficulty 1")
    cfg = AppConfig()
    cfg.mining.device = "cuda"
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.5
    chain = MockChainClient(nbits=0x1D00FFFF)
    app = Application(cfg, chain=chain)

    async def run_main_path():
        await app.start()
        try:
            t_end = time.monotonic() + MAIN_PATH_BOUND_S
            while app.engine.state.value != "running":
                check(time.monotonic() < t_end, "engine never started")
                check(not any(t.done() and not t.cancelled() and t.exception()
                              for t in app._tasks),
                      "a background task failed before the engine started")
                await asyncio.sleep(0.05)
            t_start = time.monotonic()
            watch.start(app.engine)
            at_blocks = None
            while (len(chain.submitted) < BLOCKS_NEEDED
                   or time.monotonic() < t_start + MAIN_PATH_MIN_S):
                check(time.monotonic() < t_end,
                      f"only {len(chain.submitted)} blocks in "
                      f"{MAIN_PATH_BOUND_S:.0f} s")
                await asyncio.sleep(0.05)
                if at_blocks is None and len(chain.submitted) >= BLOCKS_NEEDED:
                    at_blocks = (time.monotonic() - t_start,
                                 app.engine.stats.hashes)
            watch.stop()
            return (time.monotonic() - t_start, app.engine.stats.hashes,
                    at_blocks)
        finally:
            await app.stop()

    sc.launches.reset()
    st.calls.reset()
    watch = HashWatch()
    seconds, hashes, (blocks_s, blocks_hashes) = asyncio.run(run_main_path())
    steady_rate, steady_text = watch.summary()
    main_launches = sc.launches.value
    main_plain_calls = st.calls.value
    chain_target = tgt.bits_to_target(0x1D00FFFF)
    for height, header, block_hash in chain.submitted:
        d = hashlib.sha256(hashlib.sha256(header).digest()).digest()
        check(int.from_bytes(d, "little") <= chain_target
              and d[::-1].hex() == block_hash,
              f"block {height} fails hashlib re-check")
        print(f"   block {height}: {block_hash}", flush=True)
    check(main_launches > 0, "main path launched no kernel")
    check(main_plain_calls == 0, f"main path called the plain version "
          f"{main_plain_calls} times")
    print(f"   from the engine's start to the {BLOCKS_NEEDED}rd block: "
          f"{blocks_hashes} hashes in {blocks_s:.2f} s = "
          f"{blocks_hashes / blocks_s / 1e9:.3f} GH/s end to end; over the "
          f"whole window {len(chain.submitted)} blocks, {hashes} hashes in "
          f"{seconds:.2f} s = {hashes / seconds / 1e9:.3f} GH/s; {steady_text};"
          f" kernel launches {main_launches}, plain-version calls "
          f"{main_plain_calls}", flush=True)

    # -- 5. times ---------------------------------------------------------------
    phase("5 kernel time per 2^31-nonce launch")
    jw = random_job_words(0, None, tgt.target_to_limbs(chain_target))
    stream = torch.cuda.Stream(dev)
    out = torch.empty(sc.winner_buffer_words(k), dtype=torch.int32, device=dev)
    reps, rounds = 5, 3
    sc.sha256d_search(jw, batch=MAIN_BATCH, device=dev, stream=stream, out=out)
    round_ms = []
    with Sampler() as sampled:
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(reps):
                sc.sha256d_search(jw, batch=MAIN_BATCH, device=dev,
                                  stream=stream, out=out)
            stop.record(stream)
            stop.synchronize()
            round_ms.append(start.elapsed_time(stop) / reps)
    kernel_ms = sorted(round_ms)[rounds // 2]
    kernel_rate = MAIN_BATCH / kernel_ms * 1e3
    print(f"   {rounds} rounds of {reps} launches, ms per launch: "
          + ", ".join(f"{t:.2f}" for t in round_ms) + f"; {sampled.summary()}",
          flush=True)
    ops = sc.ops_per_nonce()
    int_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * clock_mhz * 1e6
    ops_ms = ops * MAIN_BATCH / int_ops_per_s * 1e3
    bytes_ms = (sc.JOB_WORDS + sc.winner_buffer_words(k)) * 4 / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    # the same launch over distinct difficulty-1 jobs, as the main path
    # gives them: about half of them hold a winner, whose lane escalates
    jobs = [random_job_words(0, None, tgt.target_to_limbs(chain_target))
            for _ in range(12)]
    with torch.cuda.stream(stream):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        winners = []
        for jw_ in jobs:
            sc.sha256d_search(jw_, batch=MAIN_BATCH, device=dev, stream=stream,
                              out=out)
            winners.append(out[2 * k].clone())
        stop.record(stream)
        stop.synchronize()
    jobs_ms = start.elapsed_time(stop) / len(jobs)
    print(f"   {len(jobs)} difficulty-1 jobs, {sum(int(w) for w in winners)} "
          f"winners: {jobs_ms:.2f} ms per launch; the main path's rate "
          f"(phase 4) is {blocks_hashes / blocks_s / kernel_rate:.1%} of the "
          f"kernel's from the engine's start to the {BLOCKS_NEEDED}rd block, "
          f"{hashes / seconds / kernel_rate:.1%} over the whole window and "
          f"{steady_rate / kernel_rate:.1%} steady", flush=True)
    print(f"   kernel {kernel_ms:.2f} ms = {MAIN_BATCH / kernel_ms / 1e6:.3f} GH/s;"
          f" bound {bound_ms:.2f} ms = {MAIN_BATCH / bound_ms / 1e6:.3f} GH/s "
          f"({ops} int32 ops/nonce over {props.multi_processor_count} SMs x "
          f"{INT32_LANES_PER_SM} lanes x {clock_mhz:.0f} MHz); plain version "
          f"{plain_main_s * 1e3:.0f} ms for a 2^31-lane launch; "
          f"{card}", flush=True)

    kernels = [{
        "name": "sha256d_search",
        "route": "cuda",
        "source": "otedama_tpu_torch/kernels/csrc/sha256d.cu",
        "replaces": "otedama_tpu/kernels/sha256_pallas.py:293",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_main_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "path": "solo sha256d Application (phase 4)",
    }]
    kernels += scrypt_phases(dev, card, int_ops_per_s)
    b2_record, romix_ledger, verify_err = validation_phases(
        dev, card, int_ops_per_s)
    b5 = next(r for r in kernels if r["name"] == "scrypt_romix")
    b5["path"] += (f": {b5['launches']} launches; pool ledger scrypt flushes "
                   f"through the verify path (phase 16): {romix_ledger}")
    b5["launches"] += romix_ledger
    b5["max_abs_err"] = max(b5["max_abs_err"], verify_err)
    kernels.append(b2_record)

    supervised = supervision_phases(dev, card, clock_mhz)
    switched = switch_phase(dev, card)
    rpc_launches = rpc_phase(dev, card)
    b1 = kernels[0]
    b1["path"] += (f": {b1['launches']} launches; supervised engine, two "
                   f"backends, quarantine and probes (phases 18-19): "
                   f"{supervised['launches']}; warm switch (phase 20): "
                   f"{switched['b1_launches']}; solo through the chain RPC "
                   f"client (phase 21): {rpc_launches}")
    b1["launches"] += (supervised["launches"] + switched["b1_launches"]
                       + rpc_launches)
    b5["path"] += (f"; warm switch (phase 20): {switched['b5_launches']}")
    b5["launches"] += switched["b5_launches"]
    pooled = pool_phases(dev, card, kernel_rate)
    b1["path"] += (f"; pool mode with a 1,000-miner fleet (phase 22): "
                   f"{pooled['fleet']}; vardiff from 1/64 (phase 23): "
                   f"{pooled['vardiff']}; upstream failover (phase 24): "
                   f"{pooled['failover']}")
    b1["launches"] += pooled["fleet"] + pooled["vardiff"] + pooled["failover"]
    b5["path"] += f"; scrypt pool (phase 25): {pooled['b5']}"
    b5["launches"] += pooled["b5"]
    p2p = p2p_phases(dev, card, kernel_rate)
    b1["path"] += f"; `cli p2p --mine` (phase 26): {p2p['sha256d']['b1']}"
    b1["launches"] += p2p["sha256d"]["b1"]
    b2_record["path"] += (f": {b2_record['launches']} launches; p2p sync "
                          f"pages and SHARE_BATCH gossip (phase 26): "
                          f"{p2p['sha256d']['b2']}")
    b2_record["launches"] += p2p["sha256d"]["b2"]
    b2_record["max_abs_err"] = max(b2_record["max_abs_err"],
                                   p2p["sha256d"]["max_err"])
    b5["path"] += (f"; scrypt share-chain sync pages through the verify path "
                   f"(phase 27): {p2p['scrypt']['b5']}")
    b5["launches"] += p2p["scrypt"]["b5"]
    b5["max_abs_err"] = max(b5["max_abs_err"], p2p["scrypt"]["max_err"])
    durable = durable_phase(dev, card, kernel_rate)
    b1["path"] += (f"; durable `cli p2p --mine`, killed and cold-booted "
                   f"(phase 28): {durable['b1']}")
    b1["launches"] += durable["b1"]
    b2_record["path"] += (f"; its catch-up, gossip and suffix pages (phase "
                          f"28): {durable['b2']}")
    b2_record["launches"] += durable["b2"]
    kernels += x11_phases(dev, card, clock_mhz, counting.result())
    kernels += ethash_phases(dev, card, clock_mhz, eth_counting)

    print(f"chip_smoke: every phase passed in {time.monotonic() - T0:.1f} s "
          f"since the script started; {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


TURN_ORDER = ("parent", "change", "change", "parent", "parent", "change")
_TURN_CODE = """
import os, sys
sys.path.insert(0, {tree!r})
import otedama_tpu_torch
sys.path.insert(1, {root!r})
import chip_smoke, torch
from otedama_tpu_torch.kernels import sha256_cuda
sha256_cuda.load_library()
print("package", os.path.dirname(otedama_tpu_torch.__file__), flush=True)
getattr(chip_smoke, {fn!r})(torch.device("cuda", 0),
                            chip_smoke.smi("name,power.limit"), *{args!r})
os._exit(0)
"""


def turns(parent: str, fn: str, *args: float) -> int:
    """``python3 chip_smoke.py --turns DIR FUNCTION [ARG ...]``: the phase
    function FUNCTION of this script (it takes the device, the card's name
    and the numbers ARG: ``failover_phase``, phase 24, takes none,
    ``fleet_phase``, phase 22, phase 5's B1 rate in H/s) alone, in a
    process of its own for each turn, with the ``otedama_tpu_torch``
    package under DIR (an earlier commit's, unpacked with ``git archive
    <commit> otedama_tpu_torch | tar -x -C DIR``; it builds into
    DIR/build) and with this checkout's, in the turns of ``TURN_ORDER``.
    Prints each turn's output; exits non-zero if a turn failed."""
    trees = {"parent": os.path.abspath(parent), "change": ROOT}
    rc = 0
    for name in TURN_ORDER:
        out = subprocess.run(
            [sys.executable, "-c", _TURN_CODE.format(
                tree=trees[name], root=ROOT, fn=fn, args=args)],
            capture_output=True, text=True, timeout=600)
        print(f"-- turn: {name}, {fn}, rc {out.returncode}",
              flush=True)
        print((out.stdout + out.stderr)[-4000:], flush=True)
        rc = rc or out.returncode
    print(smi("name,power.limit"), flush=True)
    return rc


# --x11-windows: (lanes a launch, shares a second, seconds, busy
# processes beside the engine) for each window
X11_WINDOW_RUNS = ((3 << 22, 2.0, 20.0, 0), (3 << 22, 2.0, 20.0, 8),
                   (1 << 24, 2.0, 20.0, 8), (5 << 22, 2.0, 20.0, 8),
                   (3 << 23, 2.0, 20.0, 8), (3 << 23, 32.0, 12.0, 8),
                   (3 << 23, 2.0, 20.0, 0))


def x11_windows() -> int:
    """``python3 chip_smoke.py --x11-windows``: phase 31's anatomy. B6's
    time a launch at each size of ``X11_WINDOW_RUNS``, then a solo x11
    ``Application`` window for each run with ``X11CudaBackend``'s launch
    set to its size and that many ``while True: pass`` processes beside
    it: the steady rate against B6's, each host re-check pass of a group's
    winners (``_X11Backend._digests``) timed, and the gaps between
    drained calls longer than 1.15 of their median (PERF.md section 6).
    Needs one card; ~3 minutes."""
    import statistics

    import torch

    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.kernels import x11_cuda as xc
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.runtime import search as rs

    check(torch.cuda.is_available(), "this run needs a CUDA card")
    print(smi("name,power.limit"), flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    prefix = bytes(range(76))

    def launch_ms(lanes):
        """median ms a B6 search launch of ``lanes`` (no winner)"""
        state = torch.empty(xc.state_words(lanes), dtype=torch.int64,
                            device=dev)

        def launch():
            xc.x11_search(prefix, 7, lanes - 1, [0] * 8, batch=lanes, k=16,
                          device=dev, stream=stream, state=state)

        return median_ms(launch, stream, 2)[0]

    b6 = {lanes: launch_ms(lanes) for lanes in
          sorted({run[0] for run in X11_WINDOW_RUNS})}
    for lanes, ms in b6.items():
        print(f"B6 {lanes} lanes: {ms:.3f} ms, {lanes / ms / 1e3:.2f} MH/s",
              flush=True)
    passes = []
    digests = rs._X11Backend._digests

    def timed(self, jc, words):
        t0 = time.monotonic()
        out = digests(self, jc, words)
        passes.append(time.monotonic() - t0)
        return out

    rs._X11Backend._digests = timed
    try:
        for lanes, shares_per_s, seconds, busy in X11_WINDOW_RUNS:
            rs.X11CudaBackend.preferred_batch = lanes
            rs.X11CudaBackend.max_batch = lanes
            b6_rate = lanes / b6[lanes] * 1e3
            nbits = tgt.target_to_bits(
                (1 << 256) // int(b6_rate / shares_per_s))
            cfg = AppConfig()
            cfg.mining.algorithm = "x11"
            cfg.mining.device = "cuda"
            cfg.work.enabled = True
            cfg.work.poll_seconds = 0.5
            app = Application(cfg, chain=MockChainClient(nbits=nbits))
            watch = HashWatch()

            async def run():
                await app.start()
                try:
                    while app.engine.state.value != "running":
                        await asyncio.sleep(0.05)
                    watch.start(app.engine)
                    await asyncio.sleep(seconds)
                    watch.stop()
                finally:
                    await app.stop()

            passes.clear()
            procs = [subprocess.Popen([sys.executable, "-c",
                                       "while True: pass"])
                     for _ in range(busy)]
            try:
                asyncio.run(run())
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
            rate, text = watch.summary()
            moves = watch.moves
            gaps = [b[0] - a[0] for a, b in zip(moves, moves[1:])]
            med = statistics.median(gaps)
            slow = [f"{(a[0] - moves[0][0]):.2f} s +{g * 1e3:.0f} ms"
                    for a, g in zip(moves, gaps) if g > 1.15 * med]
            passes.sort()
            print(f"== {lanes} lanes a launch ({3 * b6[lanes]:.0f} ms a "
                  f"group), ~{shares_per_s:g} shares/s, {busy} busy "
                  f"processes: {rate / 1e6:.2f} MH/s = {rate / b6_rate:.1%}"
                  f" of B6; {text}", flush=True)
            print(f"   {len(passes)} host passes: median "
                  f"{passes[len(passes) // 2] * 1e3:.0f} ms, p90 "
                  f"{passes[int(len(passes) * 0.9)] * 1e3:.0f} ms, max "
                  f"{passes[-1] * 1e3:.0f} ms; job changes "
                  f"{len(watch.switches)}; long gaps: {', '.join(slow)}",
                  flush=True)
    finally:
        rs._X11Backend._digests = digests
    print(smi("name,power.limit"), flush=True)
    return 0


def ethash_only() -> int:
    """``python3 chip_smoke.py --ethash``: phases 34-38 alone (the
    libraries the validator loads built first, in parallel; B7's
    resources as phase 1 prints them), then the B7 kernels' JSON record.
    Needs one card; ~4 minutes."""
    import torch

    from otedama_tpu_torch.kernels import ethash as eth
    from otedama_tpu_torch.kernels import ethash_cuda as ec
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import x11_cuda as xc

    check(torch.cuda.is_available(), "this run needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(card, flush=True)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    counts = BACKGROUND.submit(ec.instruction_counts)
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        for f in [pool.submit(load) for load in (
                sc.load_library, scc.load_library, xc.load_library,
                ec.load_library, eth.load_generator)]:
            f.result()
    ethash_resources(dev)
    records = ethash_phases(dev, card, clock_mhz, counts)
    print(f"phases 34-38 passed in {time.monotonic() - T0:.1f} s; {card}",
          flush=True)
    print(json.dumps({"kernels": records}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ethash"]:
        try:
            rc = ethash_only()
        except Exception:
            traceback.print_exc()
            rc = 1
        BACKGROUND.shutdown(wait=True, cancel_futures=True)
        sys.stdout.flush()
        os._exit(rc)
    if sys.argv[1:2] == ["--turns"]:
        os._exit(turns(sys.argv[2], sys.argv[3],
                       *(float(a) for a in sys.argv[4:])))
    if sys.argv[1:2] == ["--x11-windows"]:
        os._exit(x11_windows())
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    # the counting build's compilers end before the script does
    BACKGROUND.shutdown(wait=True, cancel_futures=True)
    sys.stdout.flush()
    sys.stderr.flush()
    # no lingering executor thread may hold the process open
    os._exit(rc)
