"""Host-side (scalar) proof-of-work digests, keyed by algorithm name
(counterpart of ``otedama_tpu/utils/pow_host.py`` for the algorithms the
port carries: the sha256d family, sha256, scrypt and x11).

Every winner a device backend reports is re-hashed here, one header at a
time, before it becomes a share, and share validation's host path and
tripwire (``runtime/validate.py``) judge shares with ``pow_digest``: the
card's kernels must agree with these bit for bit, and the tests hold them
to it.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import hashlib
import threading

# algorithms whose host validation is real CPU work (milliseconds to
# seconds a share): the stratum server digests them on the executor
# thread below instead of on the event loop. The set is the reference's;
# ethash stays refused by ``pow_digest`` until ROADMAP A10
SLOW_HOST_ALGOS = frozenset(
    {"scrypt", "litecoin", "x11", "dash", "ethash", "etchash"}
)

# lazily built thread pools, one per name, each shut down at exit
_POOLS: dict[str, concurrent.futures.ThreadPoolExecutor] = {}
_POOLS_LOCK = threading.Lock()


def named_executor(name: str) -> concurrent.futures.ThreadPoolExecutor:
    """The process's one pool of four threads called ``name``, built on
    first use."""
    pool = _POOLS.get(name)
    if pool is None:
        with _POOLS_LOCK:
            pool = _POOLS.get(name)
            if pool is None:
                pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix=name)
                # registered AFTER concurrent.futures' own exit handler,
                # so this runs FIRST (atexit is LIFO): cancel queued work
                # so interpreter exit waits for at most the in-flight calls
                atexit.register(pool.shutdown, wait=False,
                                cancel_futures=True)
                _POOLS[name] = pool
    return pool


# dedicated pool for share validation: the event loop's DEFAULT executor
# also carries every engine backend.search dispatch, and the device
# validation dispatches have a pool of their own, so host validation
# gets its own small pool
VALIDATION_POOL = "share-validate"


def validation_executor() -> concurrent.futures.ThreadPoolExecutor:
    return named_executor(VALIDATION_POOL)


def sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def scrypt_1024_1_1(data: bytes) -> bytes:
    """Litecoin's proof of work: scrypt with password = salt = the 80-byte
    header, N=1024, r=1, p=1, 32-byte output."""
    return hashlib.scrypt(
        data, salt=data, n=1024, r=1, p=1, maxmem=64 * 1024 * 1024, dklen=32
    )


def pow_digest(header: bytes, algorithm: str = "sha256d",
               block_number: int = 0) -> bytes:
    """The 32-byte PoW digest a miner's share claims for this header.
    ``block_number`` is taken for the reference's signature (ethash picks
    its epoch from it); no algorithm the port carries reads it."""
    algorithm = (algorithm or "sha256d").lower()
    if algorithm in ("sha256d", "sha256double", "bitcoin"):
        return sha256d(header)
    if algorithm == "sha256":
        return hashlib.sha256(header).digest()
    if algorithm in ("scrypt", "litecoin"):
        return scrypt_1024_1_1(header)
    if algorithm in ("x11", "dash"):
        if algorithm == "dash":
            # the coin alias implies the live network's rules: route it
            # through the registry, which refuses it while x11 is
            # uncertified (the gate covers the path that computes digests)
            from otedama_tpu_torch.engine import algos

            algos.get("dash")
        from otedama_tpu_torch.kernels.x11 import x11_digest

        return x11_digest(header)
    if algorithm in ("ethash", "etchash"):
        raise ValueError(f"no host PoW digest for {algorithm!r} in the port "
                         "yet (ethash comes with ROADMAP A10)")
    raise ValueError(f"no host PoW digest for algorithm {algorithm!r}")


def pow_digests(headers: list[bytes], algorithm: str = "sha256d",
                block_number: int = 0) -> list[bytes]:
    """``pow_digest`` of many headers of one algorithm. x11 goes through
    the host tier's lane-axis pipeline in one pass (``x11_digest_batch``:
    a pass costs about as much for one header as for a few hundred, ~0.2 s
    on a CPU core); the others hash one header at a time."""
    if (algorithm or "").lower() == "x11" and headers:
        import numpy as np

        from otedama_tpu_torch.kernels.x11 import x11_digest_batch

        rows = np.frombuffer(b"".join(headers), dtype=np.uint8).reshape(-1, 80)
        return [d.tobytes() for d in x11_digest_batch(rows)]
    return [pow_digest(h, algorithm, block_number) for h in headers]
