"""Host-side (scalar) proof-of-work digests, keyed by algorithm name
(counterpart of ``otedama_tpu/utils/pow_host.py`` for the algorithms the
port carries: the sha256d family, sha256, scrypt, x11 and ethash).

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
# seconds a share — ethash's first share of an epoch builds a whole
# cache): the stratum server digests them on the executor thread below
# instead of on the event loop. The set is the reference's
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


# epoch -> (full_size, cache): ethash share validation needs the job
# epoch's cache; two resident epochs cover a boundary transition (each
# real-chain cache is tens of MB, so the registry stays small on purpose).
# Validation runs on executor threads, so the dict is lock-guarded — but
# the LOCK is never held across a cache build: the first thread of an
# epoch builds outside the lock behind a per-epoch event, so shares for
# an already-resident epoch never wait on a boundary build.
_ETHASH_CACHES: "dict[int, tuple[int, object]]" = {}
_ETHASH_LOCK = threading.Lock()
_ETHASH_BUILDING: "dict[int, threading.Event]" = {}


def register_epoch_cache(epoch: int, full_size: int, cache) -> bool:
    """Donate a prebuilt REAL-CHAIN epoch cache (``EthashManagedBackend``
    builds one per followed epoch) so share validation never regenerates
    it. Donations with non-canonical sizing (miniature test epochs) are
    refused — this registry is keyed by epoch under real chain rules.
    Returns True when the cache was adopted."""
    from otedama_tpu_torch.kernels import ethash as eth

    bn = epoch * eth.EPOCH_LENGTH
    if full_size != eth.dataset_size(bn):
        return False
    rows = getattr(cache, "shape", (0,))[0]
    if rows * eth.HASH_BYTES != eth.cache_size(bn):
        return False
    with _ETHASH_LOCK:
        if epoch not in _ETHASH_CACHES:
            _ETHASH_CACHES[epoch] = (full_size, cache)
            _prune_caches_locked()
    return True


def _prune_caches_locked() -> None:
    while len(_ETHASH_CACHES) > 2:
        del _ETHASH_CACHES[min(_ETHASH_CACHES)]


def _epoch_cache(epoch: int) -> tuple[int, object]:
    """(full_size, cache) of an epoch: the registry's, or built here by
    the compiled generator (``kernels.ethash.make_cache``, which raises
    where it cannot be built: the python chain takes about an hour a
    real epoch)."""
    from otedama_tpu_torch.kernels import ethash as eth

    while True:
        with _ETHASH_LOCK:
            ent = _ETHASH_CACHES.get(epoch)
            if ent is not None:
                return ent
            event = _ETHASH_BUILDING.get(epoch)
            if event is None:
                event = _ETHASH_BUILDING[epoch] = threading.Event()
                building = True
            else:
                building = False
        if not building:
            # another thread is building this epoch: wait, then re-check
            # (on builder failure the entry is absent and we take over)
            event.wait()
            continue
        try:
            bn = epoch * eth.EPOCH_LENGTH
            cache = eth.make_cache(eth.cache_size(bn), eth.seed_hash(bn))
            ent = (eth.dataset_size(bn), cache)
            with _ETHASH_LOCK:
                _ETHASH_CACHES[epoch] = ent
                _prune_caches_locked()
            return ent
        finally:
            with _ETHASH_LOCK:
                _ETHASH_BUILDING.pop(epoch, None)
            event.set()


def _ethash_digests(headers: list[bytes], block_number: int) -> list[bytes]:
    """ethash digests of 80-byte headers of one epoch, in one lane-axis
    pass of the host oracle (``hashimoto_light_batch``). Framework
    conventions (``EthashManagedBackend``): header hash and nonce by
    ``ethash.share_fields``, and the big-endian result byte-reversed once
    so that digests compare as little-endian integers like every other
    algorithm's."""
    from otedama_tpu_torch.kernels import ethash as eth

    full_size, cache = _epoch_cache(block_number // eth.EPOCH_LENGTH)
    hh, nonces = eth.share_fields(headers)
    _, res = eth.hashimoto_light_batch(full_size, cache, hh, nonces)
    return [r[::-1].tobytes() for r in res]


def pow_digest(header: bytes, algorithm: str = "sha256d",
               block_number: int = 0) -> bytes:
    """The 32-byte PoW digest a miner's share claims for this header.
    ``block_number`` matters only for DAG-class algorithms (ethash picks
    its epoch from it; height-less callers get epoch 0)."""
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
        if algorithm == "etchash":
            # live-network alias: refuses while ethash is uncertified
            # (same discipline as the dash alias above)
            from otedama_tpu_torch.engine import algos

            algos.get("etchash")
        return _ethash_digests([header], block_number)[0]
    raise ValueError(f"no host PoW digest for algorithm {algorithm!r}")


def pow_digests(headers: list[bytes], algorithm: str = "sha256d",
                block_number: int = 0) -> list[bytes]:
    """``pow_digest`` of many headers of one algorithm (and, for ethash,
    one epoch). x11 goes through the host tier's lane-axis pipeline in one
    pass (``x11_digest_batch``: a pass costs about as much for one header
    as for a few hundred, ~0.2 s on a CPU core), ethash through the host
    oracle's lane-axis pass (``hashimoto_light_batch``, ~0.3 s for a few
    headers); the others hash one header at a time."""
    algo = (algorithm or "").lower()
    if algo == "x11" and headers:
        import numpy as np

        from otedama_tpu_torch.kernels.x11 import x11_digest_batch

        rows = np.frombuffer(b"".join(headers), dtype=np.uint8).reshape(-1, 80)
        return [d.tobytes() for d in x11_digest_batch(rows)]
    if algo == "ethash" and headers:
        return _ethash_digests(list(headers), block_number)
    return [pow_digest(h, algorithm, block_number) for h in headers]
