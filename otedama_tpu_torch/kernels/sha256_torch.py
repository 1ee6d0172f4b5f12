"""The plain PyTorch version of the sha256d nonce search and share check.

Counterpart of ``otedama_tpu/kernels/sha256_jax.py`` (``compress``,
``sha256d_from_midstate``, ``digest_words_to_compare_order``, ``le256``,
``compact_winners``; for share validation ``sha256d_words80``,
``compact_failures``, ``sha256d_verify_step``, ``headers_to_words``) and of
``otedama_tpu/runtime/mesh.py`` ``_local_winners_jnp``
(``sha256d_search_buffer``: the kernel's exact ``uint32[2k+3]``
winner-buffer contract, computed from the 22 job words).

It is the yardstick the CUDA kernels (``sha256_cuda``) are held against on
the card, and what the CPU tests run. It repeats the arithmetic in eager
tensor ops and is no yardstick of speed.

Words travel as int64 tensors holding values in ``[0, 2^32)``: torch's
``uint32`` lacks ``+``, ``>>``, ``<<``, ``min`` and comparisons on the CPU,
and int64 keeps every shift and compare exact (``x << 31`` of a 32-bit
value still fits). Every add is masked back to 32 bits. Convert at the
boundary with numpy ``.view(np.uint32)``.
"""

from __future__ import annotations

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter
from otedama_tpu_torch.utils.sha256_host import SHA256_IV, SHA256_K

M32 = 0xFFFFFFFF

# calls of sha256d_search_buffer and sha256d_verify_step: chip_smoke shows
# that the card's main paths make none
calls = LaunchCounter()


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _small_sigma0(x):
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _small_sigma1(x):
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


def _big_sigma0(x):
    return _rotr(x, 2) ^ _rotr(x, 13) ^ _rotr(x, 22)


def _big_sigma1(x):
    return _rotr(x, 6) ^ _rotr(x, 11) ^ _rotr(x, 25)


def _ch(e, f, g):
    return g ^ (e & (f ^ g))


def _maj(a, b, c):
    return (a & (b | c)) | (b & c)


def compress(state, w):
    """One SHA-256 compression. ``state``: 8 int64 tensors, ``w``: 16 int64
    tensors (broadcastable shapes, values in [0, 2^32)). Returns 8."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            j = i % 16
            w[j] = (w[j] + _small_sigma0(w[(i - 15) % 16]) + w[(i - 7) % 16]
                    + _small_sigma1(w[(i - 2) % 16])) & M32
        t1 = (h + _big_sigma1(e) + _ch(e, f, g) + SHA256_K[i] + w[i % 16]) & M32
        t2 = (_big_sigma0(a) + _maj(a, b, c)) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
    return tuple((x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def bswap32(x):
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def sha256d_from_midstate(midstate, tail, nonces):
    """sha256d of an 80-byte header across a lane axis of nonces.

    ``midstate``: 8 ints (compression of header[0:64]); ``tail``: 3 ints
    (header words 16..18); ``nonces``: int64 tensor (header word 19, the
    big-endian read of header bytes 76:80). Returns the 8 big-endian
    digest words, each shaped like ``nonces``."""

    def c(v):
        return torch.tensor(int(v), dtype=torch.int64, device=nonces.device)

    zero = c(0)
    pad1 = c(0x80000000)
    w = [c(tail[0]), c(tail[1]), c(tail[2]), nonces, pad1] + [zero] * 10 + [c(640)]
    d = compress(tuple(c(m) for m in midstate), w)
    w2 = list(d) + [pad1] + [zero] * 6 + [c(256)]
    return compress(tuple(c(v) for v in SHA256_IV), w2)


def digest_words_to_compare_order(d):
    """Bitcoin compares the digest as a little-endian 256-bit integer; its
    most significant 32-bit limb is ``bswap32(d[7])``."""
    return tuple(bswap32(d[7 - i]) for i in range(8))


def le256(h, t):
    """Lexicographic ``h <= t`` over 8 most-significant-first limbs:
    ``h`` 8 int64 lane tensors, ``t`` 8 ints or lane tensors."""
    le = h[7] <= t[7]
    for i in range(6, -1, -1):
        le = (h[i] < t[i]) | ((h[i] == t[i]) & le)
    return le


def compact_winners(hits, h0_masked, nonces, k: int):
    """Compact a dense in-range hit mask into the kernel's buffer layout
    ``[win_nonce[k] | win_limb[k] | n, 0, min_h0]`` (int64, values in
    [0, 2^32)): the first k winners in lane order fill the table, unused
    slots hold 0 / 0xFFFFFFFF, and a count past k is the overflow signal.
    ``h0_masked`` holds 0xFFFFFFFF on out-of-range lanes."""
    dev = hits.device
    sel = torch.nonzero(hits).flatten()[:k]
    win_nonce = torch.zeros(k, dtype=torch.int64, device=dev)
    win_limb = torch.full((k,), M32, dtype=torch.int64, device=dev)
    win_nonce[: sel.numel()] = nonces[sel]
    win_limb[: sel.numel()] = h0_masked[sel]
    best = h0_masked.min() if h0_masked.numel() else torch.tensor(M32, device=dev)
    stats = torch.stack([
        hits.sum().to(torch.int64),
        torch.zeros((), dtype=torch.int64, device=dev),
        best.to(torch.int64),
    ])
    return torch.cat([win_nonce, win_limb, stats])


def sha256d_search_buffer(job_words, *, batch: int, k: int, device,
                          chunk: int = 1 << 22):
    """The search kernel's result, computed in plain tensor ops.

    ``job_words``: the 22 ``pack_job_words`` words (``sha256_cuda``);
    ``batch``: lanes of the launch, starting at offset 0 from the nonce
    base ``job_words[11]`` (wrapping mod 2^32). Lanes past the in-range
    window (``job_words[20]`` = last offset, ``job_words[21]`` = empty
    flag) take part in neither the winners nor the min top limb.

    Runs ``chunk`` lanes at a time and merges the chunks' buffers, so a
    2^31-lane launch fits in device memory. Returns the ``uint32[2k+3]``
    buffer as an int32 tensor on ``device``, like the kernel's wrapper.
    """
    calls.add()
    device = torch.device(device)
    jw = [int(x) for x in np.asarray(job_words, dtype=np.uint32)]
    midstate, tail, base = jw[0:8], jw[8:11], jw[11]
    limbs, last, empty = jw[12:20], jw[20], jw[21]
    lanes = 0 if empty else min(batch, last + 1)
    n, best = 0, M32
    win_nonce: list[int] = []
    win_limb: list[int] = []
    for c0 in range(0, lanes, chunk):
        offs = torch.arange(c0, min(lanes, c0 + chunk), dtype=torch.int64,
                            device=device)
        nonces = (offs + base) & M32
        h = digest_words_to_compare_order(
            sha256d_from_midstate(midstate, tail, nonces))
        hits = le256(h, limbs)
        buf = compact_winners(hits, h[0], nonces, k).tolist()
        n_c = buf[2 * k]
        take = min(n_c, k - len(win_nonce))
        win_nonce += buf[:take]
        win_limb += buf[k:k + take]
        n += n_c
        best = min(best, buf[2 * k + 2])
    pad = k - len(win_nonce)
    words = (win_nonce + [0] * pad + win_limb + [M32] * pad
             + [n & M32, 0, best])
    out = np.array(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(out).to(device)


# -- share validation: the verify kernel's plain version ----------------------

def sha256d_words80(cols20):
    """sha256d of N distinct 80-byte headers across the lane axis: both
    header blocks and the digest block run per lane (no midstate is shared).
    ``cols20``: 20 int64 lane tensors, the big-endian header words. Returns
    the 8 big-endian digest words per lane."""
    zero = torch.zeros_like(cols20[0])
    pad1 = zero + 0x80000000
    iv = tuple(zero + v for v in SHA256_IV)
    st = compress(iv, list(cols20[:16]))
    d = compress(st, list(cols20[16:20]) + [pad1] + [zero] * 10 + [zero + 640])
    return compress(iv, list(d) + [pad1] + [zero] * 6 + [zero + 256])


def compact_failures(passes, h0, last: int, k: int):
    """The verify buffer ``[fail_off[k] | fail_limb[k] | n_fails, 0,
    min_h0]``: ``compact_winners`` of the FAILING lanes, with lane offsets
    in the nonce slots. Lanes past ``last`` (the last in-range offset; -1
    for none) take part in neither the failures nor the min top limb."""
    offs = torch.arange(passes.numel(), dtype=torch.int64, device=passes.device)
    rng = offs <= last
    return compact_winners(~passes & rng, torch.where(rng, h0, M32), offs, k)


def sha256d_verify_step(words20, limbs, last: int, *, k: int):
    """Share validation of ``[B, 20]`` big-endian header words against
    per-lane ``[B, 8]`` target limbs (most-significant-first): each lane's
    sha256d compared exactly with its own target, failures compacted by
    ``compact_failures``. Takes int32 bit patterns or int64 words; returns
    the ``uint32[2k+3]`` buffer as an int32 tensor on the inputs' device.
    The plain version of the verify kernel (``sha256_cuda.sha256d_verify``)."""
    calls.add()
    words = words20.to(torch.int64) & M32
    lb = limbs.to(torch.int64) & M32
    h = digest_words_to_compare_order(sha256d_words80(words.unbind(1)))
    passes = le256(h, lb.unbind(1))
    buf = compact_failures(passes, h[0], int(last), k)
    return (buf - ((buf >> 31) << 32)).to(torch.int32)


def headers_to_words(headers) -> np.ndarray:
    """Pack N 80-byte headers into the ``[N, 20]`` uint32 big-endian word
    array the verify steps take."""
    raw = b"".join(headers) if isinstance(headers, list) else \
        np.ascontiguousarray(headers).tobytes()
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(-1, 20)
