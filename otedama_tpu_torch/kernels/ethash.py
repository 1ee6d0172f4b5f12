"""Ethash, the host tier (counterpart of ``otedama_tpu/kernels/ethash.py``
``:1-230`` and ``:600-726``): the epoch rules, the cache chain, dataset
items, the hashimoto oracle and the certification gate.

- epoch machinery: seed chain, cache/dataset sizing by the prime-search
  rules (CACHE_BYTES_INIT 2^24 + 2^17/epoch, DATASET 2^30 + 2^23/epoch,
  sizes divided down to the largest prime multiple);
- cache generation: sequential keccak-512 fill + CACHE_ROUNDS of
  RandMemoHash. ``make_cache`` runs the port's compiled generator
  (``csrc/ethash_cache.cc``, built by ``cuda_build.build_host`` at first
  use: ~1M dependent keccaks for a real epoch, under a second) for the
  card and raises where it cannot be built; the python chain
  (``_python_make_cache``, the spec oracle) runs only when the caller
  asks for the CPU;
- dataset items: FNV mixing over DATASET_PARENTS cache gathers;
- hashimoto: 64 ACCESSES of 128-byte pages, FNV fold, keccak-256 seal.

``hashimoto_light_batch`` is the port's own: the light hashimoto of many
(header hash, nonce) pairs in one lane-axis numpy pass (an access's two
items for every lane at once, a parent step for every item at once). It
costs about as much for one nonce as for a few hundred (~0.3 s on a CPU
core), where the reference's ``hashimoto_light`` costs ~2.3 s a nonce
(its python loop over 256 parents an item); it is the oracle that every
winner of the card's search and the share validator's tripwire go
through, and the tests pin it to ``hashimoto_light``.

The keccak sponges run on the port's certified f1600 constants
(``kernels/x11/keccak.py``: RC, RHO, the original 0x01 padding) as a
row-vectorized permutation over ``[25, B]`` uint64 lanes.

Validation status, as in the reference: keccak-256/512 are certified
(the sha3 oracle with the 0x06 domain); the ethash composition is
self-consistent between the host oracle and the device paths, but no
offline ethash test vector is available, so the algorithm registers
``canonical=False`` and the coin alias ``etchash`` refuses until a
certification artifact's fingerprint matches (``_maybe_certify``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from otedama_tpu_torch.kernels.x11 import keccak as _keccak

WORD_BYTES = 4
DATASET_BYTES_INIT = 1 << 30
DATASET_BYTES_GROWTH = 1 << 23
CACHE_BYTES_INIT = 1 << 24
CACHE_BYTES_GROWTH = 1 << 17
EPOCH_LENGTH = 30000
MIX_BYTES = 128
HASH_BYTES = 64
DATASET_PARENTS = 256
CACHE_ROUNDS = 3
ACCESSES = 64
FNV_PRIME = 0x01000193


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    d = 3
    while d * d <= n:
        if n % d == 0:
            return False
        d += 2
    return True


def cache_size(block_number: int) -> int:
    sz = CACHE_BYTES_INIT + CACHE_BYTES_GROWTH * (block_number // EPOCH_LENGTH)
    sz -= HASH_BYTES
    while not _is_prime(sz // HASH_BYTES):
        sz -= 2 * HASH_BYTES
    return sz


def dataset_size(block_number: int) -> int:
    sz = DATASET_BYTES_INIT + DATASET_BYTES_GROWTH * (
        block_number // EPOCH_LENGTH
    )
    sz -= MIX_BYTES
    while not _is_prime(sz // MIX_BYTES):
        sz -= 2 * MIX_BYTES
    return sz


def seed_hash(block_number: int) -> bytes:
    seed = b"\x00" * 32
    for _ in range(block_number // EPOCH_LENGTH):
        seed = keccak256(seed)
    return seed


# -- keccak over the port's f1600 constants, lanes on an axis ------------------

_U64 = np.uint64
_RC = np.asarray(_keccak.RC, dtype=np.uint64)
# rho + pi as one gather: row s = x + 5y of the state rotates by RHO[x][y]
# and lands in row y + 5 * ((2x + 3y) % 5)
_RHO_ROT = np.zeros((25, 1), dtype=np.uint64)
_PI_SRC = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _RHO_ROT[_x + 5 * _y, 0] = _keccak.RHO[_x][_y]
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_RHO_BACK = (_U64(64) - _RHO_ROT) % _U64(64)
_ROT_PI = _RHO_ROT[_PI_SRC]
_BACK_PI = _RHO_BACK[_PI_SRC]


def f1600_rows(A: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] over ``[25, B]`` uint64 lanes (row x + 5y), in
    place; returns ``A``."""
    A5 = A.reshape(5, 5, -1)
    for rnd in range(24):
        C = A5[0] ^ A5[1] ^ A5[2] ^ A5[3] ^ A5[4]
        Cr = np.roll(C, -1, axis=0)
        D = np.roll(C, 1, axis=0) ^ ((Cr << _U64(1)) | (Cr >> _U64(63)))
        A5 ^= D
        P = A[_PI_SRC]
        B = ((P << _ROT_PI) | (P >> _BACK_PI)).reshape(5, 5, -1)
        A5[:] = B ^ (~np.roll(B, -1, axis=1) & np.roll(B, -2, axis=1))
        A[0] ^= _RC[rnd]
    return A


def _sponge_rows(data: np.ndarray, rate: int, out_words: int,
                 domain: int = 0x01) -> np.ndarray:
    """One-block keccak of ``[B, n]`` uint8 messages (n < rate bytes):
    the ``[B, out_words]`` little-endian uint32 digest words."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    B, n = data.shape
    if n >= rate:
        raise ValueError(f"{n} bytes do not fit one block of {rate}")
    block = np.zeros((B, rate), dtype=np.uint8)
    block[:, :n] = data
    block[:, n] ^= domain
    block[:, rate - 1] ^= 0x80
    A = np.zeros((25, B), dtype=np.uint64)
    A[:rate // 8] = block.view("<u8").T
    f1600_rows(A)
    out = np.ascontiguousarray(A[:(out_words + 1) // 2].T).astype("<u8")
    return out.view("<u4").reshape(B, -1)[:, :out_words].astype(np.uint32)


def keccak512_rows(data: np.ndarray, domain: int = 0x01) -> np.ndarray:
    """keccak-512 of ``[B, n]`` uint8 rows (n < 72) -> ``[B, 16]`` uint32."""
    return _sponge_rows(data, 72, 16, domain)


def keccak256_rows(data: np.ndarray, domain: int = 0x01) -> np.ndarray:
    """keccak-256 of ``[B, n]`` uint8 rows (n < 136) -> ``[B, 8]`` uint32."""
    return _sponge_rows(data, 136, 8, domain)


def keccak512_words(data: bytes) -> np.ndarray:
    """keccak-512 -> 16 uint32 little-endian words."""
    return keccak512_rows(np.frombuffer(data, dtype=np.uint8)[None])[0]


def keccak256(data: bytes) -> bytes:
    return keccak256_rows(
        np.frombuffer(data, dtype=np.uint8)[None])[0].astype("<u4").tobytes()


def _fnv(a, b):
    return ((a * FNV_PRIME) ^ b) & 0xFFFFFFFF


def _u8(words) -> np.ndarray:
    """uint32 words -> their little-endian bytes (row by row)."""
    w = np.ascontiguousarray(words, dtype=np.uint32).astype("<u4")
    return w.view(np.uint8).reshape(*w.shape[:-1], -1)


# -- cache generation -----------------------------------------------------------

def make_cache(size_bytes: int, seed: bytes, device="cuda") -> np.ndarray:
    """Epoch cache as ``[rows, 16]`` uint32 (row = one 64-byte hash).

    The chain is strictly sequential (~4N dependent keccaks). For the
    card (``device`` anything but ``"cpu"``) the port's compiled generator
    builds it (~1M keccaks a real epoch, under a second) and a generator
    that cannot be built raises: there is no quiet fallback to an hour of
    python. With ``device="cpu"`` the python chain (the spec oracle)
    builds it, for the CPU tests' miniature epochs."""
    rows = size_bytes // HASH_BYTES
    if str(device) == "cpu":
        return _python_make_cache(rows, seed)
    if len(seed) != 32:
        raise ValueError(f"need a 32-byte seed, got {len(seed)}")
    lib = load_generator()
    out = np.zeros((rows, 16), dtype=np.uint32)
    sb = (ctypes.c_uint8 * 32).from_buffer_copy(seed)
    lib.otedama_ethash_make_cache(rows, ctypes.addressof(sb), out.ctypes.data)
    return out


def _python_make_cache(rows: int, seed: bytes) -> np.ndarray:
    """The spec oracle (sequential keccak chain + RandMemoHash rounds).
    ONE definition — the compiled generator and the tests both validate
    against exactly this function."""
    cache = np.zeros((rows, 16), dtype=np.uint32)
    cache[0] = keccak512_words(seed)
    for i in range(1, rows):
        cache[i] = keccak512_words(cache[i - 1].tobytes())
    for _ in range(CACHE_ROUNDS):
        for i in range(rows):
            v = int(cache[i][0]) % rows
            mixed = (
                np.frombuffer(cache[(i - 1 + rows) % rows].tobytes(), "<u4")
                ^ cache[v]
            )
            cache[i] = keccak512_words(mixed.astype("<u4").tobytes())
    return cache


GENERATOR_SOURCE = "ethash_cache.cc"
_generator = None
_generator_lock = threading.Lock()
generator_info: dict = {}


def load_generator() -> ctypes.CDLL:
    """Build (once per source content) and load the compiled cache
    generator. Raises if the toolkit is missing or the build fails."""
    global _generator
    with _generator_lock:
        if _generator is None:
            from otedama_tpu_torch.kernels import cuda_build

            lib, info = cuda_build.build_host(GENERATOR_SOURCE)
            generator_info.update(info)
            lib.otedama_ethash_make_cache.argtypes = [
                ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
            lib.otedama_ethash_make_cache.restype = None
            _generator = lib
        return _generator


def calc_dataset_item(cache: np.ndarray, i: int) -> np.ndarray:
    """One 64-byte dataset item as 16 uint32 words."""
    rows = cache.shape[0]
    mix = cache[i % rows].copy()
    mix[0] = np.uint32(int(mix[0]) ^ i)
    mix = keccak512_words(mix.astype("<u4").tobytes())
    for j in range(DATASET_PARENTS):
        parent = _fnv(i ^ j, int(mix[j % 16])) % rows
        mix = np.array(
            [_fnv(int(mix[k]), int(cache[parent][k])) for k in range(16)],
            dtype=np.uint32,
        )
    return keccak512_words(mix.astype("<u4").tobytes())


# -- hashimoto (host oracle) ----------------------------------------------------

def _hashimoto_host(
    full_size: int, item_fn, header_hash: bytes, nonce: int
) -> tuple[bytes, bytes]:
    """One hashimoto on the host; ``item_fn(i) -> 16 u32 words`` supplies
    dataset items (derived for light mode, looked up for full mode) — ONE
    definition of the access loop, cmix fold, and seal for both modes."""
    n_pages = full_size // MIX_BYTES
    s_words = keccak512_words(header_hash + nonce.to_bytes(8, "little"))
    mix = np.concatenate([s_words, s_words])  # 32 uint32 = 128 bytes
    for i in range(ACCESSES):
        p = (_fnv(i ^ int(s_words[0]), int(mix[i % 32])) % n_pages) * 2
        newdata = np.concatenate([item_fn(p), item_fn(p + 1)])
        mix = np.array(
            [_fnv(int(mix[k]), int(newdata[k])) for k in range(32)],
            dtype=np.uint32,
        )
    cmix = np.array(
        [
            _fnv(_fnv(_fnv(int(mix[4 * k]), int(mix[4 * k + 1])),
                      int(mix[4 * k + 2])), int(mix[4 * k + 3]))
            for k in range(8)
        ],
        dtype=np.uint32,
    )
    mix_digest = cmix.astype("<u4").tobytes()
    result = keccak256(
        s_words.astype("<u4").tobytes() + mix_digest
    )
    return mix_digest, result


def hashimoto_light(
    full_size: int, cache: np.ndarray, header_hash: bytes, nonce: int
) -> tuple[bytes, bytes]:
    """Light verification: dataset items derived from the cache on the
    fly. Returns (mix_digest, result)."""
    return _hashimoto_host(
        full_size, lambda i: calc_dataset_item(cache, i), header_hash, nonce
    )


def hashimoto_full(
    full_size: int, dataset: np.ndarray, header_hash: bytes, nonce: int
) -> tuple[bytes, bytes]:
    """Full-dataset hashimoto (host oracle): dataset rows looked up, not
    derived. Byte-identical to ``hashimoto_light`` by construction — both
    run the ONE access loop in ``_hashimoto_host``."""
    return _hashimoto_host(
        full_size, lambda i: dataset[i], header_hash, nonce
    )


# -- the lane-axis host pass ------------------------------------------------------

_FNV = np.uint32(FNV_PRIME)


def derive_items_np(cache: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``calc_dataset_item`` of every index of ``idx`` (uint32 ``[n]``) at
    once: ``[n, 16]`` uint32."""
    rows = np.uint32(cache.shape[0])
    idx = np.asarray(idx, dtype=np.uint32)
    mix = cache[idx % rows]
    mix[:, 0] ^= idx
    mix = keccak512_rows(_u8(mix))
    # fnv(i ^ j, .)'s first half for every parent j at once
    keys = (idx[None, :] ^ np.arange(DATASET_PARENTS, dtype=np.uint32)[:, None]) \
        * _FNV
    parent = np.empty_like(idx)
    for j in range(DATASET_PARENTS):
        np.bitwise_xor(keys[j], mix[:, j % 16], out=parent)
        np.remainder(parent, rows, out=parent)
        np.multiply(mix, _FNV, out=mix)
        mix ^= cache[parent]
    return keccak512_rows(_u8(mix))


def seed_words_np(header_hashes: np.ndarray, nonces) -> np.ndarray:
    """s = keccak512(header hash || 64-bit LE nonce) of ``[B, 32]`` uint8
    header hashes: ``[B, 16]`` uint32."""
    hh = np.ascontiguousarray(header_hashes, dtype=np.uint8).reshape(-1, 32)
    nn = np.asarray(nonces, dtype=np.uint64).astype("<u8")
    return keccak512_rows(np.concatenate(
        [hh, nn.view(np.uint8).reshape(-1, 8)], axis=1))


def _hashimoto_np(full_size: int, page_fn, s: np.ndarray):
    """The access loop, cmix fold and seal over ``[B, 16]`` s-words, with
    ``page_fn(pages [B]) -> [B, 32]`` uint32: (cmix ``[B, 8]``, result
    words ``[B, 8]``)."""
    n_pages = np.uint32(full_size // MIX_BYTES)
    mix = np.concatenate([s, s], axis=1)
    for i in range(ACCESSES):
        page = ((np.uint32(i) ^ s[:, 0]) * _FNV ^ mix[:, i % 32]) % n_pages
        mix = mix * _FNV ^ page_fn(page)
    m = mix.reshape(-1, 8, 4)
    cmix = ((((m[:, :, 0] * _FNV) ^ m[:, :, 1]) * _FNV ^ m[:, :, 2]) * _FNV
            ^ m[:, :, 3])
    res = keccak256_rows(_u8(np.concatenate([s, cmix], axis=1)))
    return cmix, res


def hashimoto_light_batch(full_size: int, cache: np.ndarray, header_hashes,
                          nonces) -> tuple[np.ndarray, np.ndarray]:
    """``hashimoto_light`` of many (header hash, nonce) pairs in one
    lane-axis pass. ``header_hashes``: one 32-byte hash for every nonce,
    or one per nonce (a sequence of bytes or ``[B, 32]`` uint8).
    Returns (mix digests ``[B, 32]`` uint8, results ``[B, 32]`` uint8),
    each row the bytes ``hashimoto_light`` gives for that pair."""
    nonces = np.asarray(nonces, dtype=np.uint64).reshape(-1)
    B = len(nonces)
    if isinstance(header_hashes, (bytes, bytearray)):
        hh = np.broadcast_to(np.frombuffer(header_hashes, np.uint8), (B, 32))
    elif isinstance(header_hashes, np.ndarray):
        hh = header_hashes.reshape(B, 32)
    else:
        hh = np.frombuffer(b"".join(header_hashes), np.uint8).reshape(B, 32)
    if B == 0:
        empty = np.zeros((0, 32), dtype=np.uint8)
        return empty, empty.copy()
    cache = np.ascontiguousarray(cache, dtype=np.uint32)
    s = seed_words_np(hh, nonces)

    def page_fn(page):
        p2 = page * np.uint32(2)
        items = derive_items_np(cache, np.concatenate([p2, p2 + np.uint32(1)]))
        return np.concatenate([items[:B], items[B:]], axis=1)

    cmix, res = _hashimoto_np(full_size, page_fn, s)
    return _u8(cmix), _u8(res)


# -- the framework's share layout ------------------------------------------------

def header_hash(header76: bytes) -> bytes:
    """ethash's 32-byte header hash of a job: keccak-256 of the 76-byte
    header prefix (the framework's 80-byte header without its nonce)."""
    return keccak256(bytes(header76[:76]))


def share_fields(headers) -> tuple[np.ndarray, np.ndarray]:
    """80-byte share headers (bytes, a sequence of them, or ``[N, 80]``
    uint8) as ethash's inputs: the header hashes (``header_hash`` of each,
    ``[N, 32]`` uint8, in one lane-axis pass) and the nonces (the
    big-endian word at bytes 76:80, zero-extended to the 64-bit nonce,
    ``[N]`` uint64). The search's nonce words follow the same rule."""
    if isinstance(headers, np.ndarray):
        rows = np.ascontiguousarray(headers, dtype=np.uint8).reshape(-1, 80)
    else:
        raw = headers if isinstance(headers, (bytes, bytearray)) \
            else b"".join(headers)
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 80)
    hh = _u8(keccak256_rows(rows[:, :76]))
    nonces = rows[:, 76:80].copy().view(">u4").reshape(-1).astype(np.uint64)
    return hh, nonces


# -- registry -------------------------------------------------------------------

# ``engine/algos.py`` registers ethash with ``canonical=False``: the
# composition is from recall with no offline vector, so the coin alias
# ``etchash`` refuses until one is run (same honesty gate as x11)
from otedama_tpu_torch.engine import algos as _algos  # noqa: E402


def composition_fingerprint() -> str:
    """Deterministic mini-trace of the full composition (cache build ->
    dataset derivation -> hashimoto) on a tiny synthetic epoch — the
    certification fingerprint (utils/certification.py): recomputed at
    import when an artifact exists, so code drift after certification
    un-certifies instead of shipping silently-changed rules. The
    reference's trace; its hashimoto through the lane-axis pass."""
    cache = _python_make_cache(149, b"\x5a" * 32)
    mix, result = hashimoto_light_batch(
        1021 * MIX_BYTES, cache, b"\xa5" * 32, [0x0123456789ABCDEF]
    )
    return (mix[0].tobytes() + result[0].tobytes()).hex()


def _maybe_certify() -> bool:
    """Flip the canonical gate from the out-of-band artifact written by
    the reference's tools/certify.py after real network vectors passed
    (same two-layer trust model as kernels.x11._maybe_certify)."""
    import logging

    from otedama_tpu_torch.utils import certification

    cert = certification.get("ethash")
    if not cert:
        return False
    want = str(cert.get("fingerprint", "")).lower()
    if want and composition_fingerprint() == want:
        _algos.mark_canonical("ethash")
        return True
    logging.getLogger("otedama.kernels.ethash").warning(
        "ethash certification artifact present but the composition "
        "fingerprint no longer matches — the kernel changed since "
        "certification; keeping canonical=False",
    )
    return False


_maybe_certify()
