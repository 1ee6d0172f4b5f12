"""Batched nonce-search backends (counterpart of
``otedama_tpu/runtime/search.py``).

The host prepares per-job constants once (midstate, tail words, target
limbs); a backend consumes the nonce space in large launches, each of
which returns the fixed ``uint32[2k+3]`` winner buffer
(``kernels.sha256_cuda`` layout):

- ``CudaBackend`` — the card's hot path, the counterpart of
  ``PallasBackend``: the hand-written CUDA kernel decides winners exactly
  on the card. A group of launches is issued on the backend's own stream
  before one read-back.
- ``TorchBackend`` — the counterpart of ``XlaBackend``: the plain PyTorch
  version on a given device; the CPU tests' path.
- ``PythonBackend`` — hashlib, one nonce at a time: the zero-dependency
  oracle.
- ``ScryptCudaBackend``, ``ScryptTorchBackend``, ``ScryptPythonBackend`` —
  the same three for scrypt (Litecoin), the counterparts of
  ``ScryptPallasBackend``, ``ScryptXlaBackend`` and ``ScryptPythonBackend``.
- ``X11CudaBackend``, ``X11TorchBackend``, ``X11NumpyBackend`` — x11 (the
  JAX package's chain, ``kernels/x11``): kernel B6 on the card (the
  counterpart of ``X11JaxBackend``), its plain version, and the host
  tier's lane-axis numpy pipeline.
- ``EthashManagedBackend`` — ethash with its epoch lifecycle, over tiers
  of one epoch each: ``EthashCudaBackend`` (kernels B7a and B7b: the DAG
  built and searched on the card, or the light tier on the cache),
  ``EthashTorchBackend`` (the plain version) and ``EthashNumpyBackend``
  (the host oracle's lane-axis pass).

A launch whose table overflows (more than k winners — test-easy targets
only) is bisected: its halves are launched again, on the same backend,
until each holds at most k winners. The CUDA backend therefore never hands
a window to the plain version. (The reference rescans an overflowed x11
chunk with its dense numpy pipeline, and an overflowed ethash chunk with
its dense device pass; the port bisects both with the same kernel like the
other algorithms.)

Winner nonces use the kernel word convention: ``nonce_word`` is the
big-endian read of header bytes 76:80 (wire bytes = pack(">I", nonce_word)).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
import struct
import threading
import time

import numpy as np
import torch

from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.kernels import ethash_cuda, ethash_torch
from otedama_tpu_torch.kernels import scrypt_cuda as scc
from otedama_tpu_torch.kernels import scrypt_torch
from otedama_tpu_torch.kernels import sha256_cuda as sc
from otedama_tpu_torch.kernels import sha256_torch as st
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.kernels import x11 as x11_host
from otedama_tpu_torch.kernels import x11_cuda, x11_torch
from otedama_tpu_torch.utils import pow_host
from otedama_tpu_torch.utils import sha256_host as sh

log = logging.getLogger("otedama.runtime.search")

_M32 = 0xFFFFFFFF

# lanes per scrypt launch on the card: V takes 128 KiB per lane, so 2^18
# lanes hold 32 GiB of an 80 GB card. chip_smoke.py times 2^16..2^18
# (PERF.md section 5): the rate still rises with the lane count there.
SCRYPT_CUDA_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class JobConstants:
    """Per-job device constants, derived from the first 76 header bytes."""

    header76: bytes
    target: int
    midstate: tuple[int, ...]
    tail: tuple[int, int, int]
    limbs: np.ndarray  # uint32[8], most-significant-first
    block_number: int = 0

    @classmethod
    def from_header_prefix(cls, header76: bytes, target: int,
                           block_number: int = 0) -> "JobConstants":
        if len(header76) != 76:
            raise ValueError(f"need 76 header bytes, got {len(header76)}")
        return cls(
            header76=bytes(header76),
            target=target,
            midstate=sh.midstate(header76[:64]),
            tail=struct.unpack(">3I", header76[64:76]),
            limbs=tgt.target_to_limbs(target),
            block_number=block_number,
        )

    def header_for(self, nonce_word: int) -> bytes:
        return self.header76 + struct.pack(">I", nonce_word)

    def digest_for(self, nonce_word: int) -> bytes:
        return sh.sha256d(self.header_for(nonce_word))

    def job_words(self, base: int, count: int | None) -> np.ndarray:
        return sc.pack_job_words(self.midstate, self.tail, base, self.limbs,
                                 count=count)


@dataclasses.dataclass(frozen=True)
class Winner:
    nonce_word: int
    digest: bytes  # 32-byte sha256d of the full header

    @property
    def nonce_hex(self) -> str:
        return struct.pack(">I", self.nonce_word).hex()


@dataclasses.dataclass
class SearchResult:
    winners: list[Winner]
    hashes: int
    best_hash_hi: int  # min top compare limb observed (best-share telemetry)


def synthetic_job_constants(block_number: int = 0) -> JobConstants:
    """Fixed synthetic job for warmup/benchmark paths: target=0 means no
    winner ever fires, so a warmup launch costs device time only. The
    bytes are arbitrary but stable, so benchmark runs stay comparable."""
    header76 = bytes(range(64)) + struct.pack(
        ">3I", 0x17034219, 0x6530D1B7, 0x1D00FFFF
    )
    return JobConstants.from_header_prefix(
        header76, target=0, block_number=block_number
    )


def warmup_backend(backend, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
    """Generic ``precompile``: one minimal-count search over the backend's
    production call path, so the kernel is built and loaded before the
    engine depends on it. Returns wall seconds."""
    jc = synthetic_job_constants() if jc is None else jc
    count = 1 if count is None else max(1, int(count))
    t0 = time.monotonic()
    backend.search(jc, 0, count)
    seconds = time.monotonic() - t0
    log.info("warmed %s in %.2fs", getattr(backend, "name", "?"), seconds)
    return seconds


def _offset(nonce_word: int, base: int) -> int:
    return (nonce_word - base) & _M32


# the most slots a winner table sized from the job's target takes (a
# one-thread sort orders them after each launch); past it a window bisects
K_SIZED_MAX = 256


def table_depth(target: int, lanes: int, floor: int) -> int:
    """Winner-table slots for a window of ``lanes`` nonces at ``target``:
    the expected winners plus eight standard deviations plus eight (a
    window overflows it about never), at least ``floor``, at most
    ``K_SIZED_MAX``."""
    lam = lanes * ((target + 1) / float(1 << 256))
    return max(floor, min(K_SIZED_MAX, math.ceil(lam + 8 * math.sqrt(lam) + 8)))


class _BufferBackend:
    """Host side shared by the backends whose launches return the winner
    buffer: windows launched together before one read-back, host re-check
    of every winner, and the bisecting overflow rescan.

    Without a ``winner_depth`` the table of a group of launches is sized
    from the job's target (``table_depth``, at least 16 slots), so that a
    window at an easy share target (a pool's vardiff start, a test) does
    not overflow. A bisect is a second round of launches behind whatever
    the stream holds by then, and at a job change the engine has already
    queued the new job's first group there (ROADMAP Queue C 35). A given
    ``winner_depth`` is kept as it is."""

    name = "?"

    def __init__(self, device, winner_depth: int | None):
        self.device = torch.device(device)
        self.k = int(winner_depth or sc.K_WINNERS)
        if self.k < 1:
            raise ValueError(f"winner_depth must be >= 1, got {self.k}")
        self.sized = not winner_depth

    def _depth(self, jc: JobConstants, windows: list[tuple[int, int]]) -> int:
        """The table depth for one group of launches."""
        if not self.sized or not windows:
            return self.k
        return table_depth(jc.target, max(c for _, c in windows), self.k)

    def _launch_all(self, jc: JobConstants,
                    windows: list[tuple[int, int]], k: int) -> np.ndarray:
        """Run one launch per (base, count) window with a table of ``k``
        slots; returns the buffers as uint32 ``[len(windows), 2k+3]``."""
        raise NotImplementedError

    def _digest(self, jc: JobConstants, nonce_word: int) -> bytes:
        """The host's proof-of-work digest of one winner."""
        raise NotImplementedError

    def _digests(self, jc: JobConstants, nonce_words: list[int]) -> list[bytes]:
        """The host's digests of a group's winners."""
        return [self._digest(jc, w) for w in nonce_words]

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        return warmup_backend(self, jc, count)

    def _search_windows(
        self, jc: JobConstants, windows: list[tuple[int, int]]
    ) -> list[SearchResult]:
        """One result per window, all launched before the one read-back;
        the winners of all of them (bisects included) re-checked on the
        host together."""
        k = self._depth(jc, windows)
        bufs = self._launch_all(jc, windows, k)
        found = [self._found(jc, base, count, buf, k)
                 for (base, count), buf in zip(windows, bufs)]
        good = self._verified(jc, [w for words, _ in found for w in words])
        return [SearchResult([good[w] for w in words if w in good], count,
                             min_hash)
                for (words, min_hash), (_, count) in zip(found, windows)]

    def _verified(self, jc: JobConstants, nonce_words) -> dict[int, Winner]:
        """The winners whose host digest meets the job's target, by nonce
        word."""
        nonce_words = [int(w) for w in nonce_words]
        winners: dict[int, Winner] = {}
        if not nonce_words:
            return winners
        for w, digest in zip(nonce_words, self._digests(jc, nonce_words)):
            if not tgt.hash_meets_target(digest, jc.target):
                # the device decision is exact, so a host-side miss means
                # the DEVICE produced a wrong winner — corruption, not a
                # filter false positive. Surface it loudly and drop it.
                log.error(
                    "%s winner %#010x failed host verification "
                    "(digest=%s target=%#x) — device result corrupt?",
                    self.name, w, digest.hex(), jc.target,
                )
                continue
            winners[w] = Winner(w, digest)
        return winners

    def _found(self, jc: JobConstants, base: int, count: int,
               buf, k: int) -> tuple[list[int], int]:
        """A window's winning nonce words in offset order (bisected when
        it overflowed its table) and its min top limb."""
        wn, _, n, min_hash = sc.unpack_winner_buffer(buf, k)
        if n > k:
            return self._bisect(jc, base, count, k), min_hash
        return [int(w) for w in wn[:n]], min_hash

    def _bisect(self, jc: JobConstants, base: int, count: int,
                k: int) -> list[int]:
        """Every winning nonce word of an overflowing window: split it in
        halves and launch them (all halves of one level together) until
        each half holds at most k winners, then order them by offset."""
        words: list[int] = []
        overflowing = [(base, count)]
        while overflowing:
            halves = []
            for b, c in overflowing:
                h = c // 2  # c > k >= 1, so both halves are non-empty
                halves += [(b, h), ((b + h) & _M32, c - h)]
            overflowing = []
            for (b, c), buf in zip(halves, self._launch_all(jc, halves, k)):
                wn, _, n, _ = sc.unpack_winner_buffer(buf, k)
                if n > k:
                    overflowing.append((b, c))
                else:
                    words += [int(w) for w in wn[:n]]
        words.sort(key=lambda w: _offset(w, base))
        return words


class _Sha256dBackend(_BufferBackend):
    """sha256d: one launch per batch; the engine groups launches."""

    def _digest(self, jc: JobConstants, nonce_word: int) -> bytes:
        return jc.digest_for(nonce_word)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return self.search_group(jc, [(base, count)])[0]

    def search_group(
        self, jc: JobConstants, batches: list[tuple[int, int]]
    ) -> list[SearchResult]:
        """Run several launches with all of them issued before the one
        read-back."""
        return self._search_windows(jc, batches)


def _cuda_device(device, who: str) -> torch.device:
    """The CUDA device a card backend runs on; raises without a card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA device, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who}: torch.cuda.is_available() is False — no "
                           "CUDA device to run the kernel on")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class BackendClosedError(RuntimeError):
    """A call on a card backend after its ``close()``."""


class _CardBackend:
    """What the card backends share: the device, the backend's own stream
    (the engine launches from executor threads, so device and stream are
    explicit, never thread defaults), and the lock under which a call
    enqueues its launches and under which ``close()`` takes effect."""

    def _init_card(self, who: str) -> None:
        self.device = _cuda_device(self.device, who)
        self.stream = torch.cuda.Stream(device=self.device)
        self._lock = threading.Lock()
        self._closed = False

    @contextlib.contextmanager
    def _enqueue(self):
        """Held while a call enqueues its launches; refuses a closed
        backend, so a call abandoned by the engine that lands after
        ``close()`` raises instead of allocating its scratch again."""
        with self._lock:
            if self._closed:
                raise BackendClosedError(f"{self.name} is closed")
            yield

    def _release(self) -> None:
        """Drop the device memory the backend holds between calls."""

    def close(self, timeout: float = 30.0) -> None:
        """Refuse further calls, then free the backend's device memory
        once every launch enqueued before it has finished: its scratch
        must not be freed under a kernel still running on it. A stream
        still busy after ``timeout`` seconds (a wedged card) keeps the
        memory held, and that is logged."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        t_end = time.monotonic() + timeout
        while not self.stream.query():
            if time.monotonic() > t_end:
                log.warning("%s: its stream is still busy %.0f s after "
                            "close(); its device memory stays held",
                            self.name, timeout)
                return
            time.sleep(0.005)
        self._release()
        torch.cuda.empty_cache()


def _launch_rows(device, stream, windows, k: int, launch_one,
                 lock) -> np.ndarray:
    """Issue ``launch_one(base, count, out_row)`` for every window on
    ``stream`` into rows of one device buffer, then one pinned read-back
    and one event wait (outside ``lock``). Returns uint32 ``[windows,
    2k+3]``."""
    words = sc.winner_buffer_words(k)
    with lock, torch.cuda.device(device), torch.cuda.stream(stream):
        dev = torch.empty((len(windows), words), dtype=torch.int32,
                          device=device)
        for i, (base, count) in enumerate(windows):
            launch_one(base, count, dev[i])
        host = torch.empty((len(windows), words), dtype=torch.int32,
                           pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host.numpy().view(np.uint32)


class CudaBackend(_CardBackend, _Sha256dBackend):
    """The card's hot path: the CUDA search kernel with exact on-device
    winner selection. One launch covers a whole batch (up to 2^32 nonces),
    so the engine drives it with 2^31-nonce launches, grouped. Between
    calls it holds only its stream; ``close()`` refuses further calls."""

    name = "cuda"
    preferred_batch = 1 << 31

    def __init__(self, device="cuda", winner_depth: int | None = None):
        super().__init__(device, winner_depth)
        self._init_card("CudaBackend")

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        """Build and load the kernel library, then one warmup launch of the
        batch the engine will dispatch."""
        t0 = time.monotonic()
        sc.load_library()
        return time.monotonic() - t0 + warmup_backend(self, jc, count)

    def _launch_all(self, jc, windows, k):
        def launch(base, count, out):
            sc.sha256d_search(jc.job_words(base, count), batch=count,
                              k=k, device=self.device,
                              stream=self.stream, out=out)

        return _launch_rows(self.device, self.stream, windows, k, launch,
                            self._enqueue())


class TorchBackend(_Sha256dBackend):
    """The plain PyTorch version of the search on a given device: the
    counterpart of ``XlaBackend``. ``chunk`` bounds the lanes hashed at
    once (memory), not the batch."""

    name = "torch"

    def __init__(self, device="cpu", winner_depth: int | None = None,
                 chunk: int = 1 << 20):
        super().__init__(device, winner_depth)
        self.chunk = chunk

    def _launch_all(self, jc, windows, k):
        bufs = [
            st.sha256d_search_buffer(jc.job_words(base, count), batch=count,
                                     k=k, device=self.device,
                                     chunk=self.chunk)
            for base, count in windows
        ]
        return torch.stack(bufs).cpu().numpy().view(np.uint32)


def _scalar_search(jc: JobConstants, base: int, count: int,
                   digest_fn) -> SearchResult:
    winners: list[Winner] = []
    best = _M32
    for i in range(count):
        w = (base + i) & _M32
        digest = digest_fn(w)
        best = min(best, int.from_bytes(digest[28:32], "little"))
        if tgt.hash_meets_target(digest, jc.target):
            winners.append(Winner(w, digest))
    return SearchResult(winners, count, best)


class PythonBackend:
    """Pure-python hashlib search. Slow; the zero-dependency oracle."""

    name = "python"

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        return warmup_backend(self, jc, 1)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return _scalar_search(jc, base, count, jc.digest_for)


# -- scrypt (N=1024, r=1, p=1) -------------------------------------------------

class _ScryptBackend(_BufferBackend):
    """scrypt search over the same ``JobConstants`` as sha256d, reading only
    ``header76``, ``target`` and ``limbs`` (the nonce sits inside the PBKDF2
    password, so there is no midstate: the whole pipeline runs per lane).
    A search runs its count in launches of at most ``chunk`` lanes, all
    issued before one read-back."""

    algorithm = "scrypt"

    def __init__(self, device, winner_depth: int | None, chunk: int):
        super().__init__(device, winner_depth)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = int(chunk)
        # engine batch cap: one search call must stay short, so that a
        # clean job does not strand seconds of stale work
        self.max_batch = 4 * self.chunk

    def _digest(self, jc: JobConstants, nonce_word: int) -> bytes:
        return pow_host.scrypt_1024_1_1(jc.header_for(nonce_word))

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        windows = [((base + off) & _M32, min(self.chunk, count - off))
                   for off in range(0, count, self.chunk)]
        results = self._search_windows(jc, windows) if windows else []
        return SearchResult([w for r in results for w in r.winners], count,
                            min((r.best_hash_hi for r in results), default=_M32))


class ScryptCudaBackend(_CardBackend, _ScryptBackend):
    """scrypt on the card, the counterpart of ``ScryptPallasBackend``.

    ``tier``: ``romix`` (the default; the whole ROMix in one kernel, B5),
    ``romix-half`` (B5 keeping half of V and recomputing odd rows) or
    ``blockmix`` (the reference's ``pallas`` tier: 2,048 BlockMix
    launches, B3 and B4, around a ``torch.gather`` of V's rows). Every tier
    runs PBKDF2 and the exact compare in the search kernels' prologue and
    epilogue.

    V (128 KiB per lane, 64 KiB for ``romix-half``) is one scratch per
    backend, sized for ``chunk`` lanes: ``2^18`` lanes hold 32 GiB. The
    engine keeps several ``search`` calls in flight on executor threads;
    they share the scratch safely because every launch goes to the
    backend's one stream, which runs them in order, and a lock keeps one
    call's launches together while it enqueues them (the wait for the
    result happens outside the lock). ``close()`` frees V and the row
    scratch once the launches queued on the stream have finished."""

    def __init__(self, device="cuda", winner_depth: int | None = None,
                 chunk: int = SCRYPT_CUDA_CHUNK, tier: str = "romix"):
        if tier not in scc.TIERS:
            raise ValueError(f"unknown scrypt tier {tier!r} (known: "
                             f"{scc.TIERS})")
        super().__init__(device, winner_depth, chunk)
        self._init_card("ScryptCudaBackend")
        self.tier = tier
        self.name = "scrypt-cuda" if tier == "romix" else f"scrypt-cuda-{tier}"
        self._scratch: tuple[torch.Tensor, torch.Tensor] | None = None

    def _release(self) -> None:
        self._scratch = None

    def _scratch_for_chunk(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._scratch is None:
            v_words = scc.scratch_words(self.chunk)
            if self.tier == "romix-half":
                v_words //= 2
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                self._scratch = (
                    torch.empty(scc.ROW_WORDS * self.chunk, dtype=torch.int32,
                                device=self.device),
                    torch.empty(v_words, dtype=torch.int32, device=self.device),
                )
        return self._scratch

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        """Build and load the kernel library and allocate V, then one warmup
        search of ``count`` nonces."""
        t0 = time.monotonic()
        scc.load_library()
        with self._enqueue():
            self._scratch_for_chunk()
        return time.monotonic() - t0 + warmup_backend(self, jc, count)

    def _launch_all(self, jc, windows, k):
        h19 = scrypt_torch.header_words19(jc.header76)

        def launch(base, count, out):
            if count > self.chunk:
                raise ValueError(f"window of {count} lanes > chunk {self.chunk}")
            scc.scrypt_search(h19, base, jc.limbs, count - 1, n=count,
                              k=k, device=self.device, tier=self.tier,
                              stream=self.stream, out=out,
                              scratch=self._scratch_for_chunk())

        return _launch_rows(self.device, self.stream, windows, k, launch,
                            self._enqueue())


class ScryptTorchBackend(_ScryptBackend):
    """The plain PyTorch version of the scrypt search on a given device:
    the counterpart of ``ScryptXlaBackend``, and the tests' CPU path."""

    name = "scrypt-torch"

    def __init__(self, device="cpu", winner_depth: int | None = None,
                 chunk: int = 1 << 10):
        super().__init__(device, winner_depth, chunk)

    def _launch_all(self, jc, windows, k):
        """Windows share ROMix calls of at most ``chunk`` lanes: a call
        costs about the same for few lanes as for many, and the bisect's
        halves of one window then take one call per level."""
        h19 = scrypt_torch.header_words19(jc.header76)
        groups, lanes = [[]], 0
        for base, count in windows:
            if lanes + count > self.chunk and groups[-1]:
                groups.append([])
                lanes = 0
            groups[-1].append((base, count))
            lanes += count
        bufs = [
            scrypt_torch.scrypt_search_buffers(h19, group, jc.limbs, k=k,
                                               device=self.device)
            for group in groups if group
        ]
        return torch.cat(bufs).cpu().numpy().view(np.uint32)


class ScryptPythonBackend:
    """Scalar hashlib.scrypt search: the zero-dependency oracle."""

    name = "scrypt-python"
    algorithm = "scrypt"

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        return warmup_backend(self, jc, 1)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return _scalar_search(
            jc, base, count,
            lambda w: pow_host.scrypt_1024_1_1(jc.header_for(w)))


# -- x11 ------------------------------------------------------------------------

# lanes per x11 launch on the card (the engine groups launches as for
# sha256d, three a group, two groups in flight): a launch on B6's flat
# plateau (2^20 to 3 x 2^23 lanes, the same ns a lane) whose group of
# three takes about 0.5 s. A group's winners get one host re-check pass
# (_X11Backend._digests, 0.15-0.33 s on a busy host), and the engine
# dispatches the group after next only when that pass is done, so the
# pass hides behind ONE group on the card: a 0.25 s group left the card
# idle whenever the pass ran long. 48 chunks of the launch sequence
# (x11_cuda.CHUNK). chip_smoke.py phase 33 times B6 at this size and
# beside it (PERF.md section 6)
X11_CUDA_BATCH = 3 << 23


# lanes per ethash launch on the card's full tier (the engine groups three
# launches before one read-back): B7b full reads 8 KiB of DAG pages a hash,
# ~0.31 s a launch on an H100 (chip_smoke.py phase 36), so a group takes
# ~0.93 s, longer than the host re-check of its winners (one
# hashimoto_light_batch pass, ~0.4 s), which then hides behind one group
ETHASH_CUDA_BATCH = 1 << 26
# lanes of each window a call searches on the light tier (before the
# epoch's DAG is resident): B7b light derives 128 dataset items a hash,
# ~1.5 MH/s on an H100, so a group of three such windows takes ~0.5 s
ETHASH_LIGHT_LANES = 1 << 18
# EthashManagedBackend's epoch lifecycle: the next epoch is prefetched once
# a job comes within ETHASH_PREFETCH_BLOCKS of its boundary; at most
# ETHASH_MAX_FULL_TIERS DAGs (1 GiB and more each, plus one build in
# flight) and ETHASH_MAX_LIGHT_TIERS caches stay resident; a failed DAG
# build is retried after ETHASH_BUILD_RETRY_S seconds
ETHASH_PREFETCH_BLOCKS = 64
ETHASH_MAX_FULL_TIERS = 2
ETHASH_MAX_LIGHT_TIERS = 3
ETHASH_BUILD_RETRY_S = 300.0


def _offsets_to_nonces(bufs: np.ndarray, windows, k: int) -> np.ndarray:
    """B6 and its plain version put lane offsets in the winner slots; the
    shared host side reads nonce words there."""
    bufs = bufs.copy()
    for row, (base, _) in zip(bufs, windows):
        n = min(int(row[2 * k]), k)
        row[:n] = (row[:n].astype(np.uint64) + base) & _M32
    return bufs


class _X11Backend(_BufferBackend):
    """x11 search: launches of ``x11_winner_step``'s contract (B6 or its
    plain version) over the job's 76-byte prefix, every winner re-derived
    through the port's host chain (``kernels.x11.x11_digest``) and dropped,
    logged as corruption, if it fails there."""

    algorithm = "x11"

    def _digests(self, jc: JobConstants, nonce_words: list[int]) -> list[bytes]:
        # one pass of the host chain over the group's winners
        return pow_host.pow_digests([jc.header_for(w) for w in nonce_words],
                                    "x11")

    def _launch_x11(self, jc, windows, k) -> np.ndarray:
        raise NotImplementedError

    def _launch_all(self, jc, windows, k):
        return _offsets_to_nonces(self._launch_x11(jc, windows, k), windows, k)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return self.search_group(jc, [(base, count)])[0]

    def search_group(
        self, jc: JobConstants, batches: list[tuple[int, int]]
    ) -> list[SearchResult]:
        return self._search_windows(jc, batches)


class X11CudaBackend(_CardBackend, _X11Backend):
    """x11 on the card, kernel B6 (the counterpart of ``X11JaxBackend``):
    the nonce of each lane is made on the card, the winners decided
    exactly there. One launch covers a batch of ``X11_CUDA_BATCH`` lanes;
    the engine groups launches before one read-back, on the backend's own
    stream. Its launches pass each chunk's values through one state
    buffer (32 MiB, ``x11_cuda.state_words``), which they share safely
    because each is enqueued under the backend's lock on its one stream;
    between calls it holds its stream and that buffer, and ``close()``
    refuses further calls and frees the buffer once they have finished."""

    name = "x11-cuda"
    preferred_batch = X11_CUDA_BATCH
    max_batch = X11_CUDA_BATCH

    def __init__(self, device="cuda", winner_depth: int | None = None):
        super().__init__(device, winner_depth)
        self._init_card("X11CudaBackend")
        self._state: torch.Tensor | None = None

    def _release(self) -> None:
        self._state = None

    def _state_for_launch(self) -> torch.Tensor:
        """The state buffer; called under the enqueue lock, on the
        backend's stream."""
        if self._state is None:
            self._state = torch.empty(x11_cuda.state_words(self.max_batch),
                                      dtype=torch.int64, device=self.device)
        return self._state

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        """Build and load the kernel library and copy its tables, then one
        warmup launch of the batch the engine will dispatch."""
        t0 = time.monotonic()
        x11_cuda.load_library()
        x11_cuda.device_tables(self.device)
        return time.monotonic() - t0 + warmup_backend(self, jc, count)

    def _launch_x11(self, jc, windows, k):
        order = x11_torch.cnt_variant_order()

        def launch(base, count, out):
            x11_cuda.x11_search(jc.header76, base, count - 1, jc.limbs,
                                batch=count, k=k, device=self.device,
                                cnt_order=order, stream=self.stream, out=out,
                                state=self._state_for_launch())

        return _launch_rows(self.device, self.stream, windows, k, launch,
                            self._enqueue())


class X11TorchBackend(_X11Backend):
    """The plain PyTorch version of the x11 search on a given device: the
    tests' CPU path. ``chunk`` bounds the lanes hashed at once (memory);
    ``max_batch`` keeps one engine call short on the CPU."""

    name = "x11-torch"

    def __init__(self, device="cpu", winner_depth: int | None = None,
                 chunk: int = 1 << 10):
        super().__init__(device, winner_depth)
        self.chunk = int(chunk)
        self.max_batch = 4 * self.chunk

    def _launch_x11(self, jc, windows, k):
        """The windows' lanes share chain calls of at most ``chunk``
        lanes, so that the bisect's halves of one window take one call a
        level."""
        bufs = x11_torch.x11_search_buffers(
            jc.header76, [(base, count, count - 1) for base, count in windows],
            jc.limbs, k=k, device=self.device,
            cnt_order=x11_torch.cnt_variant_order(), chunk=self.chunk)
        return bufs.cpu().numpy().astype(np.uint32)


class X11NumpyBackend:
    """Vectorized x11 chained-hash search through the host tier's
    lane-axis numpy pipeline (``kernels.x11.x11_digest_batch``): the
    zero-dependency oracle of the x11 backends."""

    name = "x11-numpy"
    algorithm = "x11"

    def __init__(self, chunk: int = 1 << 10):
        self.chunk = chunk
        self.max_batch = 4 * chunk

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        return warmup_backend(self, jc, 1)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return _x11_chunk_search(jc, base, count, self.chunk)


def _x11_chunk_search(jc: JobConstants, base: int, count: int,
                      chunk: int) -> SearchResult:
    """The reference's x11 chunk walk over the host chain: header
    assembly, a top-limb prefilter, the exact 256-bit compare. (Its
    ``fixed_shape`` and ``cross_check`` served its jitted device tier,
    which the port's ``_X11Backend`` replaces.)"""
    winners: list[Winner] = []
    best = _M32
    done = 0
    prefix = np.frombuffer(jc.header76, dtype=np.uint8)
    top_limb = (jc.target >> 224) & _M32
    while done < count:
        n = min(chunk, count - done)
        headers = np.empty((n, 80), dtype=np.uint8)
        headers[:, :76] = prefix
        nonces = (base + done + np.arange(n, dtype=np.uint64)) & _M32
        headers[:, 76:] = nonces.astype(">u4").view(np.uint8).reshape(n, 4)
        digests = x11_host.x11_digest_batch(headers)
        # LE-int compare: top limb = last 4 digest bytes, little-endian
        hi = np.ascontiguousarray(digests[:, 28:32]).view("<u4").reshape(n)
        best = min(best, int(hi.min()))
        for idx in np.nonzero(hi <= top_limb)[0].tolist():
            digest = digests[idx].tobytes()
            if tgt.hash_meets_target(digest, jc.target):
                winners.append(Winner(int(nonces[idx]), digest))
        done += n
    return SearchResult(winners, count, best)


# -- ethash ------------------------------------------------------------------------

class _EthashEpoch:
    """One ethash epoch's host side, shared by its tiers: the sizing (real
    chain rules from ``block_number``, or an explicit miniature epoch of
    ``cache_rows`` and ``full_pages``), the host cache (built here unless
    a prebuilt one is given: the compiled generator for the card, the
    python chain for ``cache_device="cpu"``), and the winners' host
    re-check (``hashimoto_light_batch``, one pass a group)."""

    algorithm = "ethash"

    def _init_epoch(self, *, block_number=None, cache_rows=None,
                    full_pages=None, cache=None, cache_device="cuda") -> None:
        if block_number is not None:
            cache_bytes = eth.cache_size(block_number)
            self.full_size = eth.dataset_size(block_number)
            seed = eth.seed_hash(block_number)
        elif cache_rows is not None and full_pages is not None:
            # explicit miniature epoch (tests / self-consistency drills)
            cache_bytes = cache_rows * eth.HASH_BYTES
            self.full_size = full_pages * eth.MIX_BYTES
            seed = eth.seed_hash(0)
        else:
            # shares mined against a silently toy-sized DAG would be
            # invalid for any real verifier — make the choice explicit
            raise ValueError(
                "ethash needs block_number= for a real epoch, or BOTH "
                "cache_rows= and full_pages= for an explicit test epoch")
        if cache is not None:
            if cache.shape[0] * eth.HASH_BYTES != cache_bytes:
                raise ValueError(
                    f"prebuilt cache has {cache.shape[0]} rows, epoch "
                    f"sizing wants {cache_bytes // eth.HASH_BYTES}")
            self.cache = cache
        else:
            self.cache = eth.make_cache(cache_bytes, seed, device=cache_device)

    def _digests(self, jc: JobConstants, nonce_words: list[int]) -> list[bytes]:
        """The framework digests (the result byte-reversed, so that they
        compare as little-endian integers) of a group's winners, in one
        pass of the host oracle."""
        _, res = eth.hashimoto_light_batch(
            self.full_size, self.cache, eth.header_hash(jc.header76),
            nonce_words)
        return [r[::-1].tobytes() for r in res]


class _EthashTier(_EthashEpoch, _BufferBackend):
    """An epoch's search through launches of ``hashimoto_winners_device``'s
    contract (B7b or its plain version): the 76-byte prefix hashed to the
    32-byte header hash (keccak-256), each nonce word ``(base + offset)
    mod 2^32`` zero-extended to ethash's 64-bit nonce, winners as lane
    offsets, each re-derived through the host oracle and dropped, logged
    as corruption, if it fails there."""

    def _launch_eth(self, jc, windows, k) -> np.ndarray:
        raise NotImplementedError

    def _launch_all(self, jc, windows, k):
        return _offsets_to_nonces(self._launch_eth(jc, windows, k), windows, k)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return self.search_group(jc, [(base, count)])[0]

    def search_group(
        self, jc: JobConstants, batches: list[tuple[int, int]]
    ) -> list[SearchResult]:
        return self._search_windows(jc, batches)


class EthashCudaBackend(_CardBackend, _EthashTier):
    """One epoch of ethash on the card (the counterpart of
    ``EthashLightBackend(device=True)``): the epoch cache on the card and,
    with ``full_dataset``, the page-major DAG that B7a builds there at
    construction on a stream of its own (1 GiB and more an epoch). The
    light tier searches with B7b light (each page derived from the
    cache), the full tier with B7b full (each page read from the DAG).
    Launches go to the backend's own stream under its enqueue lock; a
    caller that already holds the epoch's cache on the card passes it
    (``cache_dev``) and no second copy is made. ``close()`` frees the
    DAG and the cache once the launches queued before it have finished."""

    preferred_batch = ETHASH_CUDA_BATCH
    max_batch = ETHASH_CUDA_BATCH

    def __init__(self, device="cuda", winner_depth: int | None = None, *,
                 block_number: int | None = None,
                 cache_rows: int | None = None, full_pages: int | None = None,
                 cache: np.ndarray | None = None,
                 cache_dev: torch.Tensor | None = None,
                 full_dataset: bool = False):
        _BufferBackend.__init__(self, device, winner_depth)
        self._init_card("EthashCudaBackend")
        ethash_cuda.load_library()
        self._init_epoch(block_number=block_number, cache_rows=cache_rows,
                         full_pages=full_pages, cache=cache)
        self.full = full_dataset
        self.name = "ethash-cuda-full" if full_dataset else "ethash-cuda-light"
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.cache_dev = (cache_dev if cache_dev is not None
                              else ethash_cuda.cache_tensor(self.cache,
                                                            self.device))
            self.stream.synchronize()
        # the cache is read on this backend's stream: its memory must not
        # be reused while a search queued there may still read it
        self.cache_dev.record_stream(self.stream)
        self.dag: torch.Tensor | None = None
        if full_dataset:
            build = torch.cuda.Stream(device=self.device)
            with torch.cuda.device(self.device), torch.cuda.stream(build):
                dag = ethash_cuda.build_dag(self.cache_dev, self.full_size,
                                            stream=build)
            build.synchronize()
            dag.record_stream(self.stream)
            self.dag = dag
            # the full tier never reads the cache again
            self.cache_dev = None

    def _release(self) -> None:
        self.dag = None
        self.cache_dev = None

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        t0 = time.monotonic()
        ethash_cuda.load_library()
        return time.monotonic() - t0 + warmup_backend(self, jc, count)

    def _launch_eth(self, jc, windows, k):
        hh = eth.header_hash(jc.header76)

        def launch(base, count, out):
            src = self.dag if self.full else self.cache_dev
            if src is None:
                raise BackendClosedError(f"{self.name} is closed")
            ethash_cuda.ethash_search(self.full_size, src, hh, base,
                                      count - 1, jc.limbs, batch=count, k=k,
                                      full=self.full, stream=self.stream,
                                      out=out)

        return _launch_rows(self.device, self.stream, windows, k, launch,
                            self._enqueue())


class EthashTorchBackend(_EthashTier):
    """One epoch of ethash in the plain PyTorch version on a given device
    (the tests' CPU path): the cache as int64 words there and, with
    ``full_dataset``, the DAG that ``ethash_torch.build_dataset`` builds.
    Without a prebuilt cache, the CPU builds it with the python chain."""

    def __init__(self, device="cpu", winner_depth: int | None = None, *,
                 block_number: int | None = None,
                 cache_rows: int | None = None, full_pages: int | None = None,
                 cache: np.ndarray | None = None, full_dataset: bool = False,
                 chunk: int = 1 << 6):
        _BufferBackend.__init__(self, device, winner_depth)
        self._init_epoch(block_number=block_number, cache_rows=cache_rows,
                         full_pages=full_pages, cache=cache,
                         cache_device=self.device.type)
        self.full = full_dataset
        self.name = "ethash-torch-full" if full_dataset else "ethash-torch-light"
        self.chunk = int(chunk)
        self.max_batch = 4 * self.chunk
        self.source = ethash_torch.source_tensor(self.cache, self.device)
        if full_dataset:
            self.source = ethash_torch.build_dataset(
                self.source, self.full_size).reshape(-1, 32)

    def _launch_eth(self, jc, windows, k):
        hh = eth.header_hash(jc.header76)
        bufs = [ethash_torch.winner_step(self.full_size, self.source, hh, base,
                                         count, jc.limbs, count, k,
                                         full=self.full)
                for base, count in windows]
        return torch.stack(bufs).cpu().numpy().view(np.uint32)


class EthashNumpyBackend(_EthashEpoch):
    """One epoch of ethash through the host oracle's lane-axis pass
    (``hashimoto_light_batch``), dense, ``chunk`` nonces at a time: the
    zero-dependency oracle of the ethash backends (the reference's
    ``EthashLightBackend(device=False)``, which ran ``hashimoto_light``
    a nonce at a time)."""

    name = "ethash-numpy"

    def __init__(self, *, block_number: int | None = None,
                 cache_rows: int | None = None, full_pages: int | None = None,
                 cache: np.ndarray | None = None, chunk: int = 1 << 8,
                 cache_device: str = "cuda"):
        self._init_epoch(block_number=block_number, cache_rows=cache_rows,
                         full_pages=full_pages, cache=cache,
                         cache_device=cache_device)
        self.chunk = int(chunk)
        self.max_batch = 4 * self.chunk

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        return warmup_backend(self, jc, 1)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        hh = eth.header_hash(jc.header76)
        winners: list[Winner] = []
        best = _M32
        for done in range(0, count, self.chunk):
            n = min(self.chunk, count - done)
            nonces = (base + done + np.arange(n, dtype=np.uint64)) & _M32
            _, res = eth.hashimoto_light_batch(self.full_size, self.cache, hh,
                                               nonces)
            # framework convention: digests compare as LE integers, so the
            # BE ethash result is byte-reversed once here
            digests = res[:, ::-1]
            hi = np.ascontiguousarray(digests[:, 28:32]).view("<u4").reshape(n)
            best = min(best, int(hi.min()))
            top_limb = (jc.target >> 224) & _M32
            for idx in np.nonzero(hi <= top_limb)[0].tolist():
                digest = digests[idx].tobytes()
                if tgt.hash_meets_target(digest, jc.target):
                    winners.append(Winner(int(nonces[idx]), digest))
        return SearchResult(winners, count, best)


class EthashManagedBackend:
    """ethash with its epoch lifecycle (the counterpart of the reference's
    ``EthashManagedBackend``): per-epoch tiers of one kind (``cuda``:
    ``EthashCudaBackend``; ``torch``: ``EthashTorchBackend`` on
    ``device``; ``python``: ``EthashNumpyBackend``), following the JOBS
    (``JobConstants.block_number``) across epoch boundaries without ever
    dropping the search loop:

    - on an epoch switch the new epoch's CACHE builds synchronously (the
      compiled generator: under a second a real epoch) and searches
      continue at once on the light tier (B7b light);
    - the full page-major DAG builds on a BACKGROUND thread (B7a, on a
      stream of its own, beside the engine's launches); once resident,
      searches upgrade to the full tier at a group boundary — light and
      full are byte-identical by construction, so the upgrade shows only
      in the rate;
    - the next epoch is PREFETCHED (cache and DAG) when jobs come within
      ``ETHASH_PREFETCH_BLOCKS`` of the boundary;
    - at most ``ETHASH_MAX_FULL_TIERS`` DAGs stay resident (plus one build
      in flight) and ``ETHASH_MAX_LIGHT_TIERS`` caches; older epochs are
      evicted, never the live one, and an evicted DAG's memory returns to
      the allocator once the launches queued on it are done;
    - a failed DAG build is logged, counted (``build_failures``) and
      retried after ``ETHASH_BUILD_RETRY_S``, while the light tier keeps
      searching;
    - each new epoch's host cache is donated to ``pow_host`` (the share
      validator's registry; miniature sizings are refused there).

    Where it differs from the reference: a call on the light tier searches
    only the first ``ETHASH_LIGHT_LANES`` of each window (its result's
    ``hashes`` say so): the light tier is ~100x slower than the full tier,
    and a window sized for the full tier would hold a call for tens of
    seconds; the tiers bisect an overflowed window with the same kernel
    (the reference rescans densely); ``full_dataset`` defaults to true on
    the card and false elsewhere."""

    algorithm = "ethash"
    name = "ethash-managed"

    def __init__(self, kind: str = "cuda", device=None,
                 winner_depth: int | None = None,
                 full_dataset: bool | None = None, sizing=None,
                 chunk: int | None = None):
        if kind not in ("cuda", "torch", "python"):
            raise ValueError(f"unknown ethash tier kind {kind!r}")
        if full_dataset and kind == "python":
            raise ValueError("the python tier has no DAG (full_dataset)")
        self.kind = kind
        self.device = torch.device(device if device is not None else
                                   "cuda" if kind == "cuda" else "cpu")
        if kind == "cuda":
            self.device = _cuda_device(self.device, "EthashManagedBackend")
            ethash_cuda.load_library()
        self.winner_depth = winner_depth
        self.full_dataset = (kind == "cuda") if full_dataset is None \
            else bool(full_dataset)
        if kind == "cuda":
            self.preferred_batch = self.max_batch = ETHASH_CUDA_BATCH
        else:
            self.chunk = int(chunk or (1 << 6))
            self.max_batch = 4 * self.chunk
        # sizing: epoch -> tier kwargs. Default: the real chain rules;
        # tests inject miniature epochs
        self._sizing = sizing or (
            lambda epoch: {"block_number": epoch * eth.EPOCH_LENGTH})
        # `_lock` guards the dicts and stats, held for microseconds;
        # `_tier_build_lock` serializes light-tier construction (a cache
        # build), never held with `_lock`
        self._light: dict[int, object] = {}
        self._full: dict[int, object] = {}
        self._building: set[int] = set()
        self._failed: dict[int, float] = {}
        self._live_epoch: int | None = None
        self._warned_no_height = False
        self._closed = False
        self._lock = threading.Lock()
        self._tier_build_lock = threading.Lock()
        self.stats = {"epoch_switches": 0, "full_upgrades": 0,
                      "light_calls": 0, "full_calls": 0,
                      "build_failures": 0, "evictions": 0}

    # -- tiers ---------------------------------------------------------------

    def _make_tier(self, epoch: int, full: bool, light=None):
        kw = dict(self._sizing(epoch))
        if self.kind == "python":
            return EthashNumpyBackend(chunk=self.chunk,
                                      cache_device=self.device.type, **kw)
        if light is not None:
            kw["cache"] = light.cache
        if self.kind == "cuda":
            if light is not None and light.cache_dev is not None:
                kw["cache_dev"] = light.cache_dev
            return EthashCudaBackend(self.device, self.winner_depth,
                                     full_dataset=full, **kw)
        return EthashTorchBackend(self.device, self.winner_depth,
                                  full_dataset=full, chunk=self.chunk, **kw)

    def _evict_locked(self, tiers: dict, cap: int, what: str) -> None:
        """Drop the oldest epochs past ``cap`` — never the live one."""
        while len(tiers) > cap:
            victims = [e for e in tiers if e != self._live_epoch]
            if not victims:
                break
            victim = min(victims)
            del tiers[victim]
            self.stats["evictions"] += 1
            log.info("ethash: evicted epoch %d %s", victim, what)

    def _light_tier(self, epoch: int):
        with self._lock:
            tier = self._light.get(epoch)
        if tier is not None:
            return tier
        with self._tier_build_lock:
            with self._lock:
                tier = self._light.get(epoch)
            if tier is not None:
                return tier
            tier = self._make_tier(epoch, False)
            with self._lock:
                closed = self._closed
                if not closed:
                    self._light[epoch] = tier
                    self.stats["epoch_switches"] += 1
                    self._evict_locked(self._light, ETHASH_MAX_LIGHT_TIERS,
                                       "light cache")
            if closed:
                _close_tier(tier)
                raise BackendClosedError(f"{self.name} is closed")
            try:
                pow_host.register_epoch_cache(epoch, tier.full_size,
                                              tier.cache)
            except Exception:  # a donation is an optimization, never fatal
                log.debug("epoch cache donation failed", exc_info=True)
            log.info("ethash: epoch %d cache ready (light tier live)", epoch)
        return tier

    def _build_epoch(self, epoch: int) -> None:
        """Background: the light tier first (so that a boundary crossing
        never stalls a search), then the full DAG when enabled."""
        try:
            light = self._light_tier(epoch)
            if not self.full_dataset:
                with self._lock:
                    self._building.discard(epoch)
                return
            t0 = time.monotonic()
            tier = self._make_tier(epoch, True, light)
        except Exception:
            log.exception("ethash: epoch %d build failed (light tier "
                          "continues; retry in %.0fs)", epoch,
                          ETHASH_BUILD_RETRY_S)
            with self._lock:
                self.stats["build_failures"] += 1
                self._failed[epoch] = time.monotonic()
                self._building.discard(epoch)
            return
        with self._lock:
            closed = self._closed
            if not closed:
                # registered in the section that clears `building`: a gap
                # would let a search start a duplicate build
                self._full[epoch] = tier
                self._failed.pop(epoch, None)
                self._evict_locked(self._full, ETHASH_MAX_FULL_TIERS,
                                   "full DAG")
                self.stats["full_upgrades"] += 1
            self._building.discard(epoch)
            resident = len(self._full)
        if closed:
            _close_tier(tier)
            return
        log.info("ethash: epoch %d full DAG resident in %.2fs (%d MiB; %d "
                 "epochs resident)", epoch, time.monotonic() - t0,
                 tier.full_size >> 20, resident)

    def _ensure_epoch_building(self, epoch: int) -> None:
        with self._lock:
            if epoch in self._building or self._closed:
                return
            light_done = epoch in self._light
            full_done = epoch in self._full or not self.full_dataset
            if light_done and full_done:
                return
            failed_at = self._failed.get(epoch)
            if (failed_at is not None and time.monotonic() - failed_at
                    < ETHASH_BUILD_RETRY_S):
                return
            self._building.add(epoch)
        threading.Thread(target=self._build_epoch, args=(epoch,),
                         name=f"ethash-epoch{epoch}", daemon=True).start()

    # -- search --------------------------------------------------------------

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        """Build and load the kernel library and the cache generator; with
        a job, also that job's epoch's light tier and one search of it.
        Without one no epoch is guessed (a synthetic job is epoch 0)."""
        t0 = time.monotonic()
        if self.kind == "cuda":
            ethash_cuda.load_library()
            eth.load_generator()
        if jc is not None:
            self.search(jc, 0, 1)
        return time.monotonic() - t0

    def _tier_for(self, jc: JobConstants):
        """The tier this call searches on, and whether it is the full one."""
        if self._closed:
            raise BackendClosedError(f"{self.name} is closed")
        if jc.block_number <= 0 and not self._warned_no_height:
            # a height-less feed (stratum V1) leaves block_number at 0: the
            # EPOCH-0 DAG against a chain hundreds of epochs along would make
            # every share invalid; warn loudly
            self._warned_no_height = True
            log.warning(
                "ethash: job carries block_number<=0 — mining the EPOCH-0 "
                "DAG. If this job came from a height-less feed (stratum "
                "V1), every share will be invalid on a real chain; wire the "
                "template height into Job.block_number.")
        epoch = jc.block_number // eth.EPOCH_LENGTH
        with self._lock:
            self._live_epoch = epoch
            tier = self._full.get(epoch)
        full = tier is not None
        if not full:
            self._ensure_epoch_building(epoch)
            # the CURRENT epoch's light tier builds synchronously when
            # missing: a search cannot proceed without it
            tier = self._light_tier(epoch)
        with self._lock:
            self.stats["full_calls" if full else "light_calls"] += 1
        nxt = (jc.block_number + ETHASH_PREFETCH_BLOCKS) // eth.EPOCH_LENGTH
        if nxt != epoch:
            self._ensure_epoch_building(nxt)
        return tier, full

    @staticmethod
    def _cut(full: bool, batches):
        if full:
            return list(batches)
        return [(b, min(c, ETHASH_LIGHT_LANES)) for b, c in batches]

    def search_group(
        self, jc: JobConstants, batches: list[tuple[int, int]]
    ) -> list[SearchResult]:
        tier, full = self._tier_for(jc)
        windows = self._cut(full, batches)
        if hasattr(tier, "search_group"):
            return tier.search_group(jc, windows)
        return [tier.search(jc, b, c) for b, c in windows]

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return self.search_group(jc, [(base, count)])[0]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                **self.stats,
                "full_epochs": sorted(self._full),
                "light_epochs": sorted(self._light),
                "building": sorted(self._building),
                "failed_epochs": sorted(self._failed),
                "live_epoch": self._live_epoch,
            }

    def close(self, timeout: float = 30.0) -> None:
        """Refuse further calls and close every tier (a card tier frees
        its DAG and cache once its stream is idle). A DAG build in flight
        closes its tier when it lands."""
        with self._lock:
            self._closed = True
            tiers = list(self._full.values()) + list(self._light.values())
            self._full.clear()
            self._light.clear()
        for tier in tiers:
            _close_tier(tier, timeout)


def _close_tier(tier, timeout: float = 30.0) -> None:
    close = getattr(tier, "close", None)
    if close is not None:
        close(timeout)


_BACKENDS = {
    "sha256d": {"cuda": CudaBackend, "torch": TorchBackend,
                "python": PythonBackend},
    "scrypt": {"cuda": ScryptCudaBackend, "torch": ScryptTorchBackend,
               "python": ScryptPythonBackend},
    "x11": {"cuda": X11CudaBackend, "torch": X11TorchBackend,
            "python": X11NumpyBackend},
    # every kind is the epoch-managed backend over tiers of that kind
    "ethash": {kind: functools.partial(EthashManagedBackend, kind)
               for kind in ("cuda", "torch", "python")},
}
_BACKENDS["sha256"] = _BACKENDS["sha256d"]


def make_backend(kind: str, algorithm: str = "sha256d", **kwargs):
    """``kind`` is ``cuda``, ``torch`` or ``python``; ``algorithm`` a
    canonical name (``sha256d``, ``sha256``, ``scrypt``, ``x11``,
    ``ethash``); kwargs go to the backend (``device``, ``winner_depth``,
    ``chunk``, ``tier`` for scrypt on the card, the lifecycle's knobs for
    ethash, whose every kind is ``EthashManagedBackend``)."""
    cls = _BACKENDS.get(algorithm, {}).get(kind)
    if cls is None:
        raise ValueError(f"no backend {kind!r} for algorithm {algorithm!r}")
    if kind == "python":
        kwargs.pop("device", None)
        kwargs.pop("winner_depth", None)
    return cls(**kwargs)
