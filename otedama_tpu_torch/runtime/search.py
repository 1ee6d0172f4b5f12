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

A launch whose table overflows (more than k winners — test-easy targets
only) is bisected: its halves are launched again, on the same backend,
until each holds at most k winners. The CUDA backend therefore never hands
a window to the plain version.

Winner nonces use the kernel word convention: ``nonce_word`` is the
big-endian read of header bytes 76:80 (wire bytes = pack(">I", nonce_word)).
"""

from __future__ import annotations

import dataclasses
import logging
import struct
import time

import numpy as np
import torch

from otedama_tpu_torch.kernels import sha256_cuda as sc
from otedama_tpu_torch.kernels import sha256_torch as st
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.utils import sha256_host as sh

log = logging.getLogger("otedama.runtime.search")

_M32 = 0xFFFFFFFF


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


class _BufferBackend:
    """Host side shared by the backends whose launches return the winner
    buffer: grouped launches, one read-back, host re-check of every
    winner, and the bisecting overflow rescan."""

    name = "?"

    def __init__(self, device, winner_depth: int | None):
        self.device = torch.device(device)
        self.k = int(winner_depth or sc.K_WINNERS)
        if self.k < 1:
            raise ValueError(f"winner_depth must be >= 1, got {self.k}")

    def _launch_all(self, jc: JobConstants,
                    windows: list[tuple[int, int]]) -> np.ndarray:
        """Run one launch per (base, count) window; returns the buffers as
        uint32 ``[len(windows), 2k+3]``."""
        raise NotImplementedError

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        return warmup_backend(self, jc, count)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        return self.search_group(jc, [(base, count)])[0]

    def search_group(
        self, jc: JobConstants, batches: list[tuple[int, int]]
    ) -> list[SearchResult]:
        """Run several launches with all of them issued before the one
        read-back."""
        bufs = self._launch_all(jc, batches)
        return [
            self._collect(jc, base, count, buf)
            for (base, count), buf in zip(batches, bufs)
        ]

    def _verified(self, jc: JobConstants, nonce_words) -> list[Winner]:
        winners: list[Winner] = []
        for w in nonce_words:
            w = int(w)
            digest = jc.digest_for(w)
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
            winners.append(Winner(w, digest))
        return winners

    def _collect(self, jc: JobConstants, base: int, count: int,
                 buf) -> SearchResult:
        wn, _, n, min_hash = sc.unpack_winner_buffer(buf, self.k)
        if n > self.k:
            winners = self._bisect(jc, base, count)
        else:
            winners = self._verified(jc, wn[:n])
        return SearchResult(winners, count, min_hash)

    def _bisect(self, jc: JobConstants, base: int, count: int) -> list[Winner]:
        """Every winner of an overflowing window: split it in halves and
        launch them (all halves of one level in one group) until each half
        holds at most k winners, then order the winners by offset."""
        winners: list[Winner] = []
        overflowing = [(base, count)]
        while overflowing:
            halves = []
            for b, c in overflowing:
                h = c // 2  # c > k >= 1, so both halves are non-empty
                halves += [(b, h), ((b + h) & _M32, c - h)]
            overflowing = []
            for (b, c), buf in zip(halves, self._launch_all(jc, halves)):
                wn, _, n, _ = sc.unpack_winner_buffer(buf, self.k)
                if n > self.k:
                    overflowing.append((b, c))
                else:
                    winners += self._verified(jc, wn[:n])
        winners.sort(key=lambda w: _offset(w.nonce_word, base))
        return winners


class CudaBackend(_BufferBackend):
    """The card's hot path: the CUDA search kernel with exact on-device
    winner selection. One launch covers a whole batch (up to 2^32 nonces),
    so the engine drives it with 2^31-nonce launches, grouped."""

    name = "cuda"
    preferred_batch = 1 << 31

    def __init__(self, device="cuda", winner_depth: int | None = None):
        super().__init__(device, winner_depth)
        if self.device.type != "cuda":
            raise ValueError(f"CudaBackend needs a CUDA device, got {self.device}")
        if not torch.cuda.is_available():
            raise RuntimeError("CudaBackend: torch.cuda.is_available() is "
                               "False — no CUDA device to run the kernel on")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the backend's own stream: the engine launches from executor
        # threads, so device and stream are explicit, never thread defaults
        self.stream = torch.cuda.Stream(device=self.device)

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        """Build and load the kernel library, then one warmup launch of the
        batch the engine will dispatch."""
        t0 = time.monotonic()
        sc.load_library()
        return time.monotonic() - t0 + warmup_backend(self, jc, count)

    def _launch_all(self, jc, windows):
        words = sc.winner_buffer_words(self.k)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = torch.empty((len(windows), words), dtype=torch.int32,
                              device=self.device)
            for i, (base, count) in enumerate(windows):
                sc.sha256d_search(jc.job_words(base, count), batch=count,
                                  k=self.k, device=self.device,
                                  stream=self.stream, out=dev[i])
            host = torch.empty((len(windows), words), dtype=torch.int32,
                               pin_memory=True)
            host.copy_(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return host.numpy().view(np.uint32)


class TorchBackend(_BufferBackend):
    """The plain PyTorch version of the search on a given device: the
    counterpart of ``XlaBackend``. ``chunk`` bounds the lanes hashed at
    once (memory), not the batch."""

    name = "torch"

    def __init__(self, device="cpu", winner_depth: int | None = None,
                 chunk: int = 1 << 20):
        super().__init__(device, winner_depth)
        self.chunk = chunk

    def _launch_all(self, jc, windows):
        bufs = [
            st.sha256d_search_buffer(jc.job_words(base, count), batch=count,
                                     k=self.k, device=self.device,
                                     chunk=self.chunk)
            for base, count in windows
        ]
        return torch.stack(bufs).cpu().numpy().view(np.uint32)


class PythonBackend:
    """Pure-python hashlib search. Slow; the zero-dependency oracle."""

    name = "python"

    def precompile(self, jc: JobConstants | None = None,
                   count: int | None = None) -> float:
        return warmup_backend(self, jc, 1)

    def search(self, jc: JobConstants, base: int, count: int) -> SearchResult:
        winners: list[Winner] = []
        best = _M32
        for i in range(count):
            w = (base + i) & _M32
            digest = jc.digest_for(w)
            best = min(best, int.from_bytes(digest[28:32], "little"))
            if tgt.hash_meets_target(digest, jc.target):
                winners.append(Winner(w, digest))
        return SearchResult(winners, count, best)


def make_backend(kind: str, algorithm: str = "sha256d", **kwargs):
    """``kind`` is ``cuda``, ``torch`` or ``python``; kwargs go to the
    backend (``device``, ``winner_depth``, ``chunk``)."""
    if algorithm not in ("sha256d", "sha256"):
        raise ValueError(f"no backend {kind!r} for algorithm {algorithm!r}")
    if kind == "cuda":
        return CudaBackend(**kwargs)
    if kind == "torch":
        return TorchBackend(**kwargs)
    if kind == "python":
        kwargs.pop("device", None)
        kwargs.pop("winner_depth", None)
        return PythonBackend(**kwargs)
    raise ValueError(f"no backend {kind!r} for algorithm {algorithm!r}")
