"""The plain PyTorch version of ethash's device work: the epoch DAG, the
light and full hashimoto search and share validation.

Counterpart of ``otedama_tpu/kernels/ethash.py`` ``:235-570`` and
``:611-650``: the lane-axis keccak sponges, ``_derive_items_device``
(``derive_items``), ``build_dataset_device`` (``build_dataset``),
``_hashimoto_device_words`` with its light (``_light_page_fn``) and full
(a page gather) page sources (``hashimoto_words``),
``hashimoto_winners_device`` (``winner_step``),
``hashimoto_verify_device`` (``verify_step``) and their shared
``_compact_device`` tail (``compact``, through
``sha256_torch.compact_winners``), and a dense form (``hashimoto_dense``:
mix digests and results) standing for ``hashimoto_light_device`` and
``hashimoto_full_device``. It is what the CPU tests run and what the
card's kernels B7a-B7c (``csrc/ethash.cu``, ``ethash_cuda``) are held
against; it repeats the arithmetic in eager tensor ops and is no
yardstick of speed.

Words travel as int64 tensors: 32-bit words as values in ``[0, 2^32)``
(every product masked, as in ``sha256_torch``), 64-bit keccak lanes as
their bit patterns (right shifts masked to be logical, as in
``x11_torch``). The keccak-f[1600] here runs on the state as one ``[25,
B]`` tensor, a round in two dozen tensor ops, rather than ``x11_torch``'s
25 lane tensors: ethash's light step runs two permutations for each of
its 128 dataset items a hash, and on the CPU the tests' budget is the
limit. A source (the epoch cache ``[rows, 16]``, the DAG's pages
``[n_pages, 32]``) may be int32 (the card's layout; gathered words are
masked to 32 bits) or int64 holding the words (``source_tensor``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter
from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.kernels.sha256_torch import compact_winners, le256
from otedama_tpu_torch.kernels.x11 import keccak as _keccak

M32 = 0xFFFFFFFF
FNV = eth.FNV_PRIME

# calls of build_dataset, winner_step and verify_step: chip_smoke shows
# that the card's main paths make none
calls = LaunchCounter()


def _s64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


_RC = [_s64(int(v)) for v in _keccak.RC]
_PI_SRC = [0] * 25
_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
for _d, _s in enumerate(_PI_SRC):
    _ROT[_d] = _keccak.RHO[_s % 5][_s // 5]


@functools.lru_cache(maxsize=None)
def _consts(device):
    """Per-row rotation amounts, logical-shift masks and the gather of
    rho + pi, as tensors on ``device``."""
    rot = torch.tensor(_ROT, dtype=torch.int64, device=device)[:, None]
    back = torch.where(rot == 0, 63, 64 - rot)
    mask = torch.where(rot == 0, 0, (1 << rot) - 1)
    src = torch.tensor(_PI_SRC, dtype=torch.int64, device=device)
    return rot, back, mask, src


def _rotl1(x):
    return (x << 1) | ((x >> 63) & 1)


def f1600(A: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over ``[25, B]`` int64 lanes (row x + 5y); returns
    the new state."""
    rot, back, mask, src = _consts(A.device)
    for rnd in range(24):
        A5 = A.view(5, 5, -1)
        C = A5[0] ^ A5[1] ^ A5[2] ^ A5[3] ^ A5[4]
        D = torch.roll(C, 1, 0) ^ _rotl1(torch.roll(C, -1, 0))
        P = (A5 ^ D).reshape(25, -1)[src]
        Bm = ((P << rot) | ((P >> back) & mask)).view(5, 5, -1)
        A = (Bm ^ (~torch.roll(Bm, -1, 1) & torch.roll(Bm, -2, 1))).reshape(25, -1)
        A[0] ^= _RC[rnd]
    return A


def keccak_words(words: torch.Tensor, n_bytes: int, rate: int,
                 out_words: int) -> torch.Tensor:
    """One-block keccak (original 0x01 padding) of ``[B, n_bytes / 4]``
    32-bit little-endian words: ``[B, out_words]`` digest words."""
    B, nw = words.shape
    if 4 * nw != n_bytes or n_bytes >= rate:
        raise ValueError(f"{nw} words for {n_bytes} bytes at rate {rate}")
    lanes = torch.zeros(25, B, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64) & M32
    for i in range(nw // 2):
        lanes[i] = w[:, 2 * i] | (w[:, 2 * i + 1] << 32)
    if nw % 2:
        lanes[nw // 2] = w[:, nw - 1]
    lanes[n_bytes // 8] ^= 0x01 << (8 * (n_bytes % 8))
    lanes[rate // 8 - 1] ^= _s64(0x80 << 56)
    A = f1600(lanes)
    out = []
    for i in range((out_words + 1) // 2):
        out += [A[i] & M32, (A[i] >> 32) & M32]
    return torch.stack(out[:out_words], 1)


def keccak512(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    return keccak_words(words, n_bytes, 72, 16)


def keccak256(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    return keccak_words(words, n_bytes, 136, 8)


def fnv(a, b):
    return ((a * FNV) & M32) ^ b


def source_tensor(array, device) -> torch.Tensor:
    """A numpy uint32 source (the epoch cache ``[rows, 16]``, a DAG) as
    the int64 words this module computes on."""
    return torch.from_numpy(np.ascontiguousarray(array, dtype=np.uint32)
                            .astype(np.int64)).to(device)


def _words(src: torch.Tensor) -> torch.Tensor:
    """A source as int64 words (an int64 source already holds them)."""
    return src if src.dtype == torch.int64 else src.to(torch.int64) & M32


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _words(src[idx])


def derive_items(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dataset items ``idx`` (int64 ``[n]``, each < 2^32) from the epoch
    cache: ``[n, 16]`` words (``_derive_items_device``)."""
    rows = cache.shape[0]
    cache = _words(cache)
    mix = _gather(cache, idx % rows)
    mix[:, 0] ^= idx
    mix = keccak512(mix, 64)
    j = torch.arange(eth.DATASET_PARENTS, dtype=torch.int64,
                     device=idx.device)[:, None]
    keys = ((idx[None, :] ^ j) * FNV) & M32           # fnv(i ^ j, .) halves
    for jj in range(eth.DATASET_PARENTS):
        parent = (keys[jj] ^ mix[:, jj % 16]) % rows
        mix = fnv(mix, _gather(cache, parent))
    return keccak512(mix, 64)


def build_dataset(cache: torch.Tensor, full_size: int,
                  chunk: int = 1 << 16) -> torch.Tensor:
    """The whole DAG, ``[n_items, 16]`` int64 words (page-major it is the
    same memory as ``[n_pages, 32]``), ``chunk`` items at a time
    (``build_dataset_device``, which pads to whole chunks; this writes
    exactly ``n_items``)."""
    calls.add()
    n_items = full_size // eth.HASH_BYTES
    parts = []
    for c0 in range(0, n_items, chunk):
        idx = torch.arange(c0, min(n_items, c0 + chunk), dtype=torch.int64,
                           device=cache.device)
        parts.append(derive_items(cache, idx))
    return torch.cat(parts) if parts else torch.zeros(0, 16, dtype=torch.int64)


def light_page_fn(cache: torch.Tensor):
    """Pages derived from the cache: page p is items 2p and 2p + 1."""
    cache = _words(cache)

    def page_fn(page):
        n = page.shape[0]
        items = derive_items(cache, torch.cat([2 * page, 2 * page + 1]))
        return torch.cat([items[:n], items[n:]], 1)

    return page_fn


def full_page_fn(pages: torch.Tensor):
    """Pages gathered from the DAG (``[n_pages, 32]`` or item-major)."""
    pages = pages.reshape(-1, 32)
    return lambda page: _gather(pages, page)


def hash_words(header_hashes) -> torch.Tensor:
    """32-byte header hashes (bytes, a sequence of them or ``[N, 32]``
    uint8) -> ``[N, 8]`` int64 little-endian words."""
    if isinstance(header_hashes, (bytes, bytearray)):
        raw = bytes(header_hashes)
    elif isinstance(header_hashes, np.ndarray):
        raw = np.ascontiguousarray(header_hashes, dtype=np.uint8).tobytes()
    else:
        raw = b"".join(header_hashes)
    return torch.from_numpy(np.frombuffer(raw, dtype="<u4").astype(np.int64)
                            .reshape(-1, 8))


def seed_words(hh: torch.Tensor, nonces: torch.Tensor) -> torch.Tensor:
    """s = keccak512(header hash || 64-bit LE nonce): ``hh`` ``[B, 8]``
    words (or ``[1, 8]``, broadcast), ``nonces`` int64 ``[B]`` (< 2^63)."""
    B = nonces.shape[0]
    inp = torch.empty(B, 10, dtype=torch.int64, device=nonces.device)
    inp[:, :8] = hh.to(nonces.device)
    inp[:, 8] = nonces & M32
    inp[:, 9] = (nonces >> 32) & M32
    return keccak512(inp, 40)


def hashimoto_words(full_size: int, page_fn, s: torch.Tensor):
    """The access loop, cmix fold and keccak-256 seal over ``[B, 16]``
    s-words (``_hashimoto_device_words``): (cmix ``[B, 8]``, result words
    ``[B, 8]``)."""
    n_pages = full_size // eth.MIX_BYTES
    mix = torch.cat([s, s], 1)
    for i in range(eth.ACCESSES):
        page = fnv(i ^ s[:, 0], mix[:, i % 32]) % n_pages
        mix = fnv(mix, page_fn(page))
    cmix = fnv(fnv(fnv(mix[:, 0::4], mix[:, 1::4]), mix[:, 2::4]),
               mix[:, 3::4])
    return cmix, keccak256(torch.cat([s, cmix], 1), 96)


def _bswap32(x):
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def result_limbs(res: torch.Tensor):
    """The framework's compare-order limbs of result words
    (``_result_limbs``): the byte-swapped words, in word order."""
    return tuple(_bswap32(res[:, i]) for i in range(8))


def compact(res: torch.Tensor, limbs8, last: int, k: int, *,
            invert: bool) -> torch.Tensor:
    """``_compact_device``: the exact compare of each lane's result
    against the target limbs (8 ints, or ``[B, 8]`` per lane), winners
    (``invert=False``) or failures (``invert=True``) of the lanes up to
    offset ``last`` compacted with lane offsets; the min top limb over
    those lanes. Returns the ``uint32[2k+3]`` buffer as int32."""
    h = result_limbs(res)
    if torch.is_tensor(limbs8) and limbs8.dim() == 2:
        lb = limbs8.to(torch.int64) & M32
        t = lb.unbind(1)
    else:
        t = [int(x) for x in np.asarray(limbs8, dtype=np.uint64)]
    le = le256(h, t)
    offs = torch.arange(res.shape[0], dtype=torch.int64, device=res.device)
    rng = offs <= last
    flagged = ((~le) if invert else le) & rng
    buf = compact_winners(flagged, torch.where(rng, h[0], M32), offs, k)
    return (buf - ((buf >> 31) << 32)).to(torch.int32)


def _page_fn(full_size: int, source: torch.Tensor, full: bool):
    return full_page_fn(source) if full else light_page_fn(source)


def window_nonces(base: int, lanes: int, device) -> torch.Tensor:
    """The nonces of a search window: (base + offset) mod 2^32."""
    return (torch.arange(lanes, dtype=torch.int64, device=device)
            + base) & M32


def winner_step(full_size: int, source: torch.Tensor, header_hash: bytes,
                base: int, lanes: int, limbs8, count: int, k: int, *,
                full: bool = False, chunk: int | None = None) -> torch.Tensor:
    """The search step (``hashimoto_winners_device``): ``lanes`` nonces
    from ``base`` (mod 2^32, the 64-bit seed nonce zero-extended), the
    first ``count`` in range; ``source`` the epoch cache (light) or the
    DAG's pages (``full``); the lanes hashed ``chunk`` at a time (default:
    all at once), which bounds the memory of a large window. Returns the
    ``uint32[2k+3]`` winner buffer (lane offsets) as int32."""
    calls.add()
    nonces = window_nonces(base, lanes, source.device)
    hw = hash_words(header_hash)
    page_fn = _page_fn(full_size, source, full)
    step = chunk or max(lanes, 1)
    res = torch.cat([hashimoto_words(full_size, page_fn,
                                     seed_words(hw, nonces[c0:c0 + step]))[1]
                     for c0 in range(0, max(lanes, 1), step)])
    return compact(res, limbs8, count - 1, k, invert=False)


def verify_step(full_size: int, cache: torch.Tensor, hh: torch.Tensor,
                nonces: torch.Tensor, limbs: torch.Tensor, count: int,
                k: int) -> torch.Tensor:
    """Share validation (``hashimoto_verify_device``): ``hh`` ``[N, 8]``
    header-hash words, ``nonces`` int64 ``[N]``, ``limbs`` ``[N, 8]``
    per-share target limbs; the light hashimoto of each row, failures of
    the first ``count`` compacted. Returns the ``uint32[2k+3]`` buffer as
    int32."""
    calls.add()
    dev = cache.device
    s = seed_words(hh.to(dev).to(torch.int64) & M32, nonces.to(dev))
    _, res = hashimoto_words(full_size, light_page_fn(cache), s)
    return compact(res, limbs.to(dev), count - 1, k, invert=True)


def hashimoto_dense(full_size: int, source: torch.Tensor, header_hashes,
                    nonces, *, full: bool = False):
    """Dense results (``hashimoto_light_device`` / ``hashimoto_full_device``):
    mix digests and results, ``[B, 32]`` uint8 numpy arrays, for one
    header hash or one per nonce."""
    dev = source.device
    nn = torch.as_tensor(np.asarray(nonces, dtype=np.uint64).astype(np.int64),
                         device=dev)
    s = seed_words(hash_words(header_hashes).to(dev), nn)
    cmix, res = hashimoto_words(full_size, _page_fn(full_size, source, full), s)

    def as_bytes(w):
        return eth._u8(w.cpu().numpy().astype(np.uint32))

    return as_bytes(cmix), as_bytes(res)
