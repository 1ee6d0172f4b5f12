"""Device-batched share validation — the device INGEST path (counterpart of
``otedama_tpu/runtime/validate.py``).

Miner-submitted shares, already assembled into batches by the
group-commit ledger (``PoolManager.on_share_batch``), are verified on the
card as ONE dispatch per algorithm group instead of one host hash per
share.

Contract (the search path's winner buffers, run in reverse): every tier's
verify kernels hash N submitted 80-byte headers, compare each lane EXACTLY
(256-bit lexicographic) against its OWN share target, and compact the rare
FAILURES — honest shares were mined to target, so a failing lane is
Byzantine input or corruption — into one fixed ``uint32[2k+3]`` buffer
(``sha256_cuda.unpack_winner_buffer`` layout, lane offsets in the nonce
slots). One read-back per batch; a failure count past ``k`` (a heavily
Byzantine batch) is settled on the card: the same kernels run the batch
again with a table of that many slots.

The device tiers: the sha256d family on the verify kernel B2
(``sha256_cuda.sha256d_verify``), scrypt on the verify prologue, the ROMix
kernel B5 and the verify epilogue (``scrypt_cuda.scrypt_verify``), x11 on
B6's verify kernel (``x11_cuda.x11_verify``) or, with ``x11_chain =
"numpy"``, on the host tier's lane-axis pipeline (``x11_verify_batch``,
the reference's ``"numpy"`` tier); ethash on kernel B7c
(``ethash_cuda.ethash_verify``), each group one epoch: the epoch's cache
comes from ``pow_host``'s registry and stays on the validator's device
(two epochs at most).

Safety rails, in the same shape as the device SEARCH path's:

- **Crossover**: batches under ``min_batch`` shares go straight to the
  host (``pow_host.pow_digest`` on the validation executor) — device
  dispatch overhead loses below a measured size.
- **Tripwire**: a seeded sample of every device batch is re-verified
  through the independent host oracle.
- **Fault point** ``validation.verify`` (error / corrupt / delay on the
  device verdict): an injected error quarantines the device path for
  ``quarantine_seconds`` and every batch host-validates meanwhile; an
  injected corrupt verdict is caught by the tripwire, which degrades the
  batch to host validation and quarantines, as the reference does.

Only the injected faults take that way out. The kernels' libraries are
built and loaded when a ``cuda`` backend is constructed, and that raises;
a kernel that fails to launch raises out of ``verify_batch``; and a
tripwire mismatch that no fault injected means the kernels are wrong,
and raises too. No kernel fault ever hides behind a host verdict.

Where the port differs from the reference: ``device`` names a torch
device (``"cuda"``, the default, or ``"cpu"`` for the plain versions)
and ``None`` means host only (the reference's ``device=False``); nothing
pads batches to compiled shapes (there is no compile cache to protect);
the reference's ``rolled`` knob is gone; ``x11_chain`` takes ``"cuda"``
(its ``"jax"``) or ``"numpy"`` and defaults to ``"cuda"`` (the reference's
default is ``"numpy"`` because its XLA compile takes minutes); an x11
batch's host work (the tripwire, the host path) is one pass of the
lane-axis pipeline, not one host digest a share; a device
error, an overflow and a tripwire mismatch take the ways above, where the
reference host-validates all three; device dispatches run on threads of
their own (``dispatch_executor``), not on the loop's default executor.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import logging
import random
import threading
import time

import numpy as np
import torch

from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.kernels import ethash_cuda
from otedama_tpu_torch.kernels import scrypt_cuda as scc
from otedama_tpu_torch.kernels import sha256_cuda as sc
from otedama_tpu_torch.kernels import sha256_torch
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.kernels import x11_cuda
from otedama_tpu_torch.utils import faults
from otedama_tpu_torch.utils import pow_host
from otedama_tpu_torch.utils.histogram import LatencyHistogram

log = logging.getLogger("otedama.runtime.validate")

_VERIFY_FAULTS = faults.DEVICE

# device dispatch pays off only past this batch size: on an H100 a whole
# verify_batch call on the card (read-back and tripwire included) first
# beats the host executor at 32 shares, for sha256d and scrypt alike
# (chip_smoke.py phase 17); platform-dependent, hence the knob
VALIDATE_MIN_BATCH = 32

# share-count distribution bounds for the batch-size histogram (the
# latency histogram class is unit-agnostic: bounds are just numbers)
_BATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 4096.0)

# the threads that run device dispatches and wait for their read-backs:
# on the card a dispatch waits until the verify kernel has run, and the
# verify kernel does not start beside a running search kernel B1 (B1's
# persistent blocks hold every SM for its whole launch, ~289 ms on an
# H100), so a dispatch on the loop's default executor held a thread that
# long and starved the engine's own hops there (chip_smoke.py phase 26)
def dispatch_executor() -> concurrent.futures.ThreadPoolExecutor:
    return pow_host.named_executor("validate-dispatch")


# algorithms with a device verify tier. Deliberately NARROW: "sha256"
# (single hash) has no device twin and must not fall into the sha256d
# kernel; "dash" and "etchash" (the live-network aliases) are refused by
# the host oracle while x11 and ethash are uncertified
_SHA256D_ALGOS = frozenset({"sha256d", "sha256double", "bitcoin"})
_SCRYPT_ALGOS = frozenset({"scrypt", "litecoin"})
_X11_ALGOS = frozenset({"x11"})
_ETHASH_ALGOS = frozenset({"ethash"})
_DEVICE_ALGOS = _SHA256D_ALGOS | _SCRYPT_ALGOS | _X11_ALGOS | _ETHASH_ALGOS
# algorithms whose host digests go through one lane-axis pass for many
# shares (``pow_host.pow_digests``), not a call a share
_BATCH_HOST_ALGOS = _X11_ALGOS | _ETHASH_ALGOS
# epoch caches a validator keeps on its device
ETHASH_RESIDENT_EPOCHS = 2
X11_CHAINS = ("cuda", "numpy")


@dataclasses.dataclass(frozen=True)
class ShareCheck:
    """One share's validation claim: the exact 80 bytes the miner
    hashed, the target its credited difficulty demands, and the
    algorithm/height that pick the digest function."""

    header: bytes
    target: int
    algorithm: str = "sha256d"
    block_number: int = 0


def _epoch_of(check: ShareCheck) -> int:
    """The ethash epoch a share's height picks (0 for other algorithms)."""
    if (check.algorithm or "").lower() in ("ethash", "etchash"):
        return check.block_number // eth.EPOCH_LENGTH
    return 0


class _Staging:
    """One device dispatch's buffers, owned by one dispatch at a time: the
    batch's input rows (header words and target limbs; for ethash header
    hashes, nonces and limbs) in pinned host memory and on the card (one
    after the other in one block, so one asynchronous copy moves them all,
    each part starting 16-byte aligned), the failure buffer on the card
    and its pinned read-back, and the event that marks the read-back done.
    Every buffer persists and only grows."""

    def __init__(self, device: torch.device):
        self.device = device
        self._host_in = self._card_in = None
        self._host_np = None
        self._card_out = self._host_out = None
        self._done = torch.cuda.Event()

    def inputs(self, *parts: np.ndarray):
        """Stage ``parts`` (uint32 ``[n, w]`` arrays, e.g. words ``[n, 20]``
        and limbs ``[n, 8]``) and copy them to the card on the current
        stream; returns the card's int32 views of the same shapes."""
        starts, need = [], 0
        for part in parts:
            starts.append(need)
            need += -(-part.size // 4) * 4      # each part 16-byte aligned
        if self._host_in is None or self._host_in.numel() < need:
            size = 1 << max(12, (need - 1).bit_length())
            self._host_in = self._card_in = None    # free the old ones first
            self._host_in = torch.empty(size, dtype=torch.int32,
                                        pin_memory=True)
            self._host_np = self._host_in.numpy()
            self._card_in = torch.empty(size, dtype=torch.int32,
                                        device=self.device)
        for at, part in zip(starts, parts):
            self._host_np[at:at + part.size] = part.view(np.int32).reshape(-1)
        self._card_in[:need].copy_(self._host_in[:need], non_blocking=True)
        return tuple(self._card_in[at:at + part.size].view(part.shape)
                     for at, part in zip(starts, parts))

    def output(self, k: int) -> torch.Tensor:
        """The card's ``uint32[2k+3]`` failure buffer for this dispatch."""
        words = 2 * k + 3
        if self._card_out is None or self._card_out.numel() < words:
            self._card_out = torch.empty(words, dtype=torch.int32,
                                         device=self.device)
        return self._card_out[:words]

    def read_back(self, buf: torch.Tensor) -> None:
        """Copy ``buf`` into the pinned read-back on the current stream and
        mark it done there."""
        if self._host_out is None or self._host_out.numel() < buf.numel():
            self._host_out = torch.empty(buf.numel(), dtype=torch.int32,
                                         pin_memory=True)
        self._host_out[:buf.numel()].copy_(buf, non_blocking=True)
        self._done.record()

    def result(self, words: int) -> np.ndarray:
        """Wait for the read-back; a copy of its ``words`` words."""
        self._done.synchronize()
        return self._host_out[:words].numpy().view(np.uint32).copy()


class ValidationBackend:
    """Batches share-validation work onto the card, with a host
    crossover, a sampled host-oracle tripwire, and the rails of the
    ``validation.verify`` fault point.

    One instance serves every producer in the process: the stats and
    histograms are one surface, and the quarantine state is shared — a
    device that corrupted a ledger batch must not keep verifying other
    producers' batches.

    Device dispatches run on executor threads, several at once. They all
    go to the backend's one CUDA stream, each with a staging slot of its
    own from a small pool (pinned host buffers and card buffers that
    persist and only grow: one copy in, the kernels, one read-back); the
    scrypt tier's V scratch is shared, so a lock holds one dispatch's
    scrypt launches together while they are enqueued (the wait for the
    read-back is outside it), as ``ScryptCudaBackend`` does. An x11
    dispatch's stages pass their values through a state buffer of the
    dispatch's own, so x11 dispatches interleave on the stream freely, and
    so do ethash dispatches (B7c reads the epoch's cache and writes only
    the dispatch's own buffer).

    ethash shares are grouped by epoch (``block_number``), each group one
    dispatch against that epoch's cache, which comes from ``pow_host``'s
    registry (``_epoch_cache``: donated by the miner's backend, or built
    by the compiled generator) and is kept on the validator's device, at
    most ``ETHASH_RESIDENT_EPOCHS`` of them.
    """

    def __init__(self, *, min_batch: int = VALIDATE_MIN_BATCH,
                 tripwire_rate: float = 0.05, k: int | None = None,
                 quarantine_seconds: float = 60.0,
                 device: str | torch.device | None = "cuda", seed: int = 0,
                 x11_chain: str = "cuda"):
        self.min_batch = max(1, int(min_batch))
        self.tripwire_rate = float(tripwire_rate)
        self.k = int(k or sc.K_WINNERS)
        if self.k < 1:
            raise ValueError(f"winner_depth must be >= 1, got {self.k}")
        self.quarantine_seconds = float(quarantine_seconds)
        if x11_chain not in X11_CHAINS:
            raise ValueError(f"unknown x11 validation chain {x11_chain!r} "
                             f"(known: {X11_CHAINS})")
        self.x11_chain = x11_chain
        self.device = None if device is None else torch.device(device)
        self.stream = None
        if self.device is not None:
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "ValidationBackend: torch.cuda.is_available() is "
                        "False — no CUDA device for the verify kernels "
                        "(pass device='cpu' for the plain versions, or "
                        "None for host validation)")
                if self.device.index is None:
                    self.device = torch.device("cuda",
                                               torch.cuda.current_device())
                # build and load now: a kernel that does not build must
                # raise here, not quarantine on the first batch
                scc.load_library()
                if x11_chain == "cuda":
                    x11_cuda.load_library()
                    x11_cuda.device_tables(self.device)
                ethash_cuda.load_library()
                self.stream = torch.cuda.Stream(device=self.device)
            elif self.device.type != "cpu":
                raise ValueError(f"ValidationBackend runs on cuda or cpu, "
                                 f"not {self.device}")
        # the scrypt tier's (x, V) scratch, grown to the largest batch
        self._scrypt_scratch: tuple[torch.Tensor, torch.Tensor] | None = None
        # the card dispatches' staging buffers that no dispatch holds
        self._staging: list[_Staging] = []
        # epoch -> (full_size, the epoch cache on the validator's device)
        self._eth_caches: dict[int, tuple[int, torch.Tensor]] = {}
        self._enqueue_lock = threading.Lock()
        # deterministic tripwire sampling: chaos runs replay exactly
        self._rng = random.Random(seed)
        self._quarantined_until = 0.0
        self._lock = threading.Lock()
        self.stats = {
            "validated_device": 0,
            "validated_host": 0,
            "device_batches": 0,
            "host_batches": 0,
            "crossover_batches": 0,   # host because under min_batch
            "device_errors": 0,
            "overflows": 0,           # failure table overflowed (> k)
            "tripwire_checks": 0,
            "tripwire_mismatches": 0,
            "rejects": 0,             # shares that failed validation
        }
        self.batch_sizes = LatencyHistogram(bounds=_BATCH_BOUNDS)
        self.device_seconds = LatencyHistogram()
        self.host_seconds = LatencyHistogram()
        # min top compare limb ever observed (best-share telemetry, the
        # unit the search kernels report)
        self.best_hash_hi = 0xFFFFFFFF

    # -- device state ---------------------------------------------------------

    def device_ok(self) -> bool:
        return (self.device is not None
                and time.monotonic() >= self._quarantined_until)

    def _quarantine(self) -> None:
        self._quarantined_until = (
            time.monotonic() + self.quarantine_seconds)

    # -- the host oracle ------------------------------------------------------

    @staticmethod
    def _host_verdicts_of(checks: list[ShareCheck]) -> list[bool]:
        """Exact verdicts of shares of one algorithm
        (``pow_host.pow_digests``)."""
        first = checks[0]
        digests = pow_host.pow_digests([c.header for c in checks],
                                       first.algorithm, first.block_number)
        return [tgt.hash_meets_target(d, c.target)
                for d, c in zip(digests, checks)]

    async def _host_verdicts(self, checks: list[ShareCheck]) -> list[bool]:
        """Exact host verdicts, CONCURRENT on the validation executor: the
        x11 shares in one call, the ethash shares of an epoch in one call
        (their host passes cost about the same whatever the count), any
        other share a call of its own."""
        loop = asyncio.get_running_loop()
        pool = pow_host.validation_executor()
        batched: dict[tuple[str, int], list[int]] = {}
        for i, c in enumerate(checks):
            algo = (c.algorithm or "").lower()
            if algo in _BATCH_HOST_ALGOS:
                batched.setdefault((algo, _epoch_of(c)), []).append(i)
        units = list(batched.values())
        done = {i for unit in units for i in unit}
        units += [[i] for i in range(len(checks)) if i not in done]
        parts = await asyncio.gather(*(
            loop.run_in_executor(pool, self._host_verdicts_of,
                                 [checks[i] for i in unit])
            for unit in units
        ))
        verdicts = [False] * len(checks)
        for unit, part in zip(units, parts):
            for i, ok in zip(unit, part):
                verdicts[i] = ok
        return verdicts

    async def _verify_host(self, checks: list[ShareCheck]) -> list[bool]:
        """Exact per-share host validation, CONCURRENT on the validation
        executor."""
        t0 = time.monotonic()
        verdicts = await self._host_verdicts(checks)
        self.host_seconds.observe(time.monotonic() - t0)
        with self._lock:
            self.stats["host_batches"] += 1
            self.stats["validated_host"] += len(checks)
        return verdicts

    # -- the device kernels ---------------------------------------------------

    def _scratch_for(self, lanes: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The scrypt tier's (x, V) scratch for ``lanes`` lanes; called
        under the enqueue lock, on the backend's stream."""
        have = self._scrypt_scratch
        if have is None or have[0].numel() < scc.ROW_WORDS * lanes:
            self._scrypt_scratch = None   # free the old one first
            self._scrypt_scratch = (
                torch.empty(scc.ROW_WORDS * lanes, dtype=torch.int32,
                            device=self.device),
                torch.empty(scc.scratch_words(lanes), dtype=torch.int32,
                            device=self.device))
        return self._scrypt_scratch

    def _device_buffer(self, algorithm: str, checks: list[ShareCheck],
                       k: int) -> np.ndarray:
        """One device dispatch: the algorithm tier's verify kernels over
        the batch. Returns the ``uint32[2k+3]`` failure buffer. Runs on an
        executor thread (it waits for the read-back); a kernel that fails
        raises."""
        if algorithm not in _DEVICE_ALGOS:
            # defensive: verify_batch's _DEVICE_ALGOS routing makes this
            # unreachable — an unknown algorithm must fail loudly, never
            # silently run the wrong kernel
            raise ValueError(f"no device verify tier for {algorithm!r}")
        n = len(checks)
        x11 = algorithm in _X11_ALGOS
        if x11 and self.x11_chain == "numpy":
            return self._x11_numpy_buffer(checks, k)
        if algorithm in _ETHASH_ALGOS:
            return self._ethash_buffer(checks, k)
        words = sha256_torch.headers_to_words([c.header for c in checks])
        limbs = np.stack([tgt.target_to_limbs(c.target) for c in checks])
        scrypt = algorithm in _SCRYPT_ALGOS
        if self.device.type != "cuda":
            w = torch.from_numpy(words.view(np.int32))
            t = torch.from_numpy(limbs.view(np.int32))
            verify = (scc.scrypt_verify if scrypt else
                      x11_cuda.x11_verify if x11 else sc.sha256d_verify)
            return verify(w, t, n, k=k).numpy().view(np.uint32)
        with self._lock:
            slot = self._staging.pop() if self._staging else _Staging(self.device)
        with contextlib.ExitStack() as ctx:
            if scrypt:
                # the V scratch is shared: one dispatch enqueues at a time
                ctx.enter_context(self._enqueue_lock)
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(self.stream))
            w, t = slot.inputs(words, limbs)
            if scrypt:
                buf = scc.scrypt_verify(w, t, n, k=k,
                                        scratch=self._scratch_for(n),
                                        stream=self.stream)
            elif x11:
                # no lock: each dispatch's stages pass their values through
                # a state of its own (x11_verify's default, for this call)
                buf = x11_cuda.x11_verify(w, t, n, k=k, stream=self.stream,
                                          out=slot.output(k))
            else:
                buf = sc.sha256d_verify(w, t, n, k=k, stream=self.stream,
                                        out=slot.output(k))
            slot.read_back(buf)
        result = slot.result(sc.winner_buffer_words(k))
        # a dispatch that raised keeps its slot: its copies may still run
        with self._lock:
            self._staging.append(slot)
        return result

    def _ethash_cache(self, epoch: int) -> tuple[int, torch.Tensor]:
        """(full_size, cache on the validator's device) of an epoch: from
        ``pow_host``'s registry, copied to the device once; the oldest of
        more than ``ETHASH_RESIDENT_EPOCHS`` is dropped."""
        with self._lock:
            ent = self._eth_caches.get(epoch)
        if ent is not None:
            return ent
        full_size, cache = pow_host._epoch_cache(epoch)
        # on the card: allocated on (and so freed after) the dispatches' stream
        with (torch.cuda.stream(self.stream) if self.stream is not None
              else contextlib.nullcontext()):
            dev = ethash_cuda.cache_tensor(cache, self.device)
        with self._lock:
            ent = self._eth_caches.setdefault(epoch, (full_size, dev))
            while len(self._eth_caches) > ETHASH_RESIDENT_EPOCHS:
                del self._eth_caches[min(self._eth_caches)]
        return ent

    def _ethash_buffer(self, checks: list[ShareCheck], k: int) -> np.ndarray:
        """One ethash dispatch (one epoch): each share's header hash and
        nonce (``ethash.share_fields``, on the host in one lane-axis pass)
        through B7c against its target. Returns the ``uint32[2k+3]``
        failure buffer."""
        n = len(checks)
        full_size, cache = self._ethash_cache(_epoch_of(checks[0]))
        hh, nonces = ethash_cuda.share_rows(
            *eth.share_fields([c.header for c in checks]))
        limbs = np.stack([tgt.target_to_limbs(c.target) for c in checks])
        if self.device.type != "cuda":
            parts = [torch.from_numpy(x.view(np.int32))
                     for x in (hh, nonces, limbs)]
            return ethash_cuda.ethash_verify(full_size, cache, *parts, n,
                                             k=k).numpy().view(np.uint32)
        with self._lock:
            slot = self._staging.pop() if self._staging else _Staging(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            h, nn, t = slot.inputs(hh, nonces, limbs)
            buf = ethash_cuda.ethash_verify(full_size, cache, h, nn, t, n,
                                            k=k, stream=self.stream,
                                            out=slot.output(k))
            slot.read_back(buf)
        result = slot.result(sc.winner_buffer_words(k))
        # a dispatch that raised keeps its slot: its copies may still run
        with self._lock:
            self._staging.append(slot)
        return result

    @staticmethod
    def _x11_numpy_buffer(checks: list[ShareCheck], k: int) -> np.ndarray:
        """The reference's ``"numpy"`` x11 tier: verdicts from the host
        tier's lane-axis pipeline (``x11_verify_batch``), put in the same
        failure buffer as the kernels' (its limb half left unset, as
        there) so that every tier is one path downstream."""
        from otedama_tpu_torch.kernels import x11 as x11_host

        headers = np.frombuffer(b"".join(c.header for c in checks),
                                dtype=np.uint8).reshape(-1, 80)
        verdicts, best = x11_host.x11_verify_batch(
            headers, [c.target for c in checks])
        fails = np.nonzero(~verdicts)[0]
        buf = np.zeros((sc.winner_buffer_words(k),), dtype=np.uint32)
        buf[k:2 * k] = 0xFFFFFFFF
        buf[:min(k, len(fails))] = fails[:k]
        buf[2 * k] = len(fails)
        buf[2 * k + 2] = best
        return buf

    async def _verify_device_group(
        self, algorithm: str, checks: list[ShareCheck]
    ) -> list[bool] | None:
        """One algorithm group through the device path. Returns verdicts,
        or None when an injected fault sends the group to the host."""
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        try:
            d = faults.hit("validation.verify", algorithm, _VERIFY_FAULTS)
        except Exception:
            with self._lock:
                self.stats["device_errors"] += 1
            self._quarantine()
            return None
        corrupt = False
        if d is not None:
            if d.delay:
                await asyncio.sleep(d.delay)
            corrupt = d.corrupt
        buf = await loop.run_in_executor(
            dispatch_executor(), self._device_buffer, algorithm, checks,
            self.k)
        offs, _, n_fails, min_h0 = sc.unpack_winner_buffer(buf, self.k)
        if n_fails > self.k:
            # heavily Byzantine batch: the compact table cannot name every
            # failure — run the batch again with a slot for each of them
            with self._lock:
                self.stats["overflows"] += 1
            buf = await loop.run_in_executor(
                dispatch_executor(), self._device_buffer, algorithm, checks,
                n_fails)
            offs, _, again, min_h0 = sc.unpack_winner_buffer(buf, n_fails)
            if again != n_fails:
                raise RuntimeError(
                    f"device validation counted {n_fails} then {again} "
                    f"failures in one {algorithm} batch of {len(checks)}")
        verdicts = [True] * len(checks)
        for s in range(n_fails):
            off = int(offs[s])
            if off < len(verdicts):
                verdicts[off] = False
        if corrupt:
            # injected wrong-result mode: the device "answered" with
            # every verdict inverted — exactly what the tripwire exists
            # to catch
            verdicts = [not v for v in verdicts]

        # sampled host-oracle tripwire (the search path's winner re-check
        # applied to ingest): per batch, at least one share re-verified host-side
        # — CONCURRENTLY on the executor (the cost is one slowest hash,
        # not the sum), and BEFORE the device path's success accounting
        # so a discarded batch never inflates the device/host split
        if self.tripwire_rate > 0:
            sample = [i for i in range(len(checks))
                      if self._rng.random() < self.tripwire_rate]
            if not sample:
                sample = [self._rng.randrange(len(checks))]
            with self._lock:
                self.stats["tripwire_checks"] += len(sample)
            host_oks = await self._host_verdicts([checks[i] for i in sample])
            mismatch = False
            for i, host_ok in zip(sample, host_oks):
                if host_ok != verdicts[i]:
                    mismatch = True
                    log.error(
                        "validation tripwire: device verdict %s for "
                        "share %d (%s) but host oracle says %s — device "
                        "result corrupt", verdicts[i], i, algorithm, host_ok,
                    )
            if mismatch:
                with self._lock:
                    self.stats["tripwire_mismatches"] += 1
                if not corrupt:
                    raise RuntimeError(
                        f"validation tripwire: the {algorithm} verify "
                        f"kernels disagree with the host oracle on a batch "
                        f"of {len(checks)}")
                self._quarantine()
                return None
        self.device_seconds.observe(time.monotonic() - t0)
        with self._lock:
            self.stats["device_batches"] += 1
            self.stats["validated_device"] += len(checks)
            self.best_hash_hi = min(self.best_hash_hi, int(min_h0))
        return verdicts

    # -- public API -----------------------------------------------------------

    async def verify_batch(self, checks: list[ShareCheck]) -> list[bool]:
        """Validate one batch of submitted shares. Returns one verdict
        per share (True = the header's PoW digest meets its target),
        bit-identical to the host oracle's answer by construction —
        the device compare is exact and every degradation path ends at
        ``pow_host``."""
        if not checks:
            return []
        self.batch_sizes.observe(float(len(checks)))
        verdicts: list[bool | None] = [None] * len(checks)
        # group by (algorithm, ethash epoch): each group is one device
        # dispatch (mixed-algorithm batches cross chain boundaries
        # legitimately)
        groups: dict[tuple[str, int], list[int]] = {}
        for i, c in enumerate(checks):
            algo = (c.algorithm or "sha256d").lower()
            groups.setdefault((algo, _epoch_of(c)), []).append(i)
        for (algo, _epoch), idxs in groups.items():
            sub = [checks[i] for i in idxs]
            group_verdicts: list[bool] | None = None
            device_eligible = algo in _DEVICE_ALGOS
            if (device_eligible and self.device_ok()
                    and len(sub) >= self.min_batch):
                group_verdicts = await self._verify_device_group(algo, sub)
            elif device_eligible and len(sub) < self.min_batch:
                with self._lock:
                    self.stats["crossover_batches"] += 1
            if group_verdicts is None:
                group_verdicts = await self._verify_host(sub)
            for i, v in zip(idxs, group_verdicts):
                verdicts[i] = v
        rejects = sum(1 for v in verdicts if not v)
        if rejects:
            with self._lock:
                self.stats["rejects"] += rejects
        return [bool(v) for v in verdicts]

    # -- reporting ------------------------------------------------------------

    def executor_queue_depth(self) -> int:
        """Pending work on the shared validation executor — the
        host-path backpressure signal (a deep queue means host
        validation is the wall again)."""
        pool = pow_host._POOLS.get(pow_host.VALIDATION_POOL)
        if pool is None:
            return 0
        try:
            return pool._work_queue.qsize()
        except Exception:
            return 0

    def snapshot(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
        return {
            **stats,
            "device_ok": self.device_ok(),
            "min_batch": self.min_batch,
            "executor_queue_depth": self.executor_queue_depth(),
            "best_hash_hi": self.best_hash_hi,
            "batch_size": {
                "count": self.batch_sizes.count,
                "avg": round(
                    self.batch_sizes.sum / self.batch_sizes.count, 2)
                if self.batch_sizes.count else 0.0,
                "p50": self.batch_sizes.quantile(0.5),
                "p99": self.batch_sizes.quantile(0.99),
            },
            "device_seconds": self.device_seconds.snapshot(),
            "host_seconds": self.host_seconds.snapshot(),
        }
