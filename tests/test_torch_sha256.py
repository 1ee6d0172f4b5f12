"""Port parity, kernel level: the PyTorch package's host helpers and the
plain version of the sha256d search kernel against the JAX package.

Inputs are made with numpy from fixed seeds and go through both packages.
The JAX side runs its exactness oracles on the CPU: the jnp twin
(``sha256_jax``, rolled rounds) and ``runtime/mesh._local_winners_jnp``,
which computes the Pallas kernel's exact ``uint32[2k+3]`` buffer. All
comparisons are exact (integer arithmetic, no tolerance).
"""

from __future__ import annotations

import hashlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otedama_tpu.kernels import sha256_jax as sj
from otedama_tpu.kernels import sha256_pallas as sp
from otedama_tpu.kernels import target as ref_tgt
from otedama_tpu.runtime import mesh
from otedama_tpu.utils import sha256_host as ref_sh
from otedama_tpu_torch.kernels import sha256_cuda as sc
from otedama_tpu_torch.kernels import sha256_torch as st
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.utils import sha256_host as sh

K = 16
BATCH = 4096
M32 = 0xFFFFFFFF

_ref_buffer = jax.jit(mesh._local_winners_jnp,
                      static_argnames=("batch", "k", "rolled"))
_ref_digest = jax.jit(sj.sha256d_from_midstate, static_argnames=("rolled",))


def _rand_job(rng):
    ms = rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(np.uint32)
    tail = rng.integers(0, 1 << 32, size=3, dtype=np.uint64).astype(np.uint32)
    return ms, tail


def _ref_digest_words(ms, tail, nonces):
    d = _ref_digest(tuple(jnp.uint32(x) for x in ms),
                    tuple(jnp.uint32(x) for x in tail),
                    jnp.asarray(nonces, dtype=jnp.uint32), rolled=True)
    return np.stack([np.asarray(x) for x in d]).astype(np.int64)


def _port_digest_words(ms, tail, nonces):
    d = st.sha256d_from_midstate([int(x) for x in ms], [int(x) for x in tail],
                                 torch.as_tensor(nonces.astype(np.int64)))
    return torch.stack(d).numpy()


# -- (a) host helpers -----------------------------------------------------------

def test_host_sha256_helpers_match_reference():
    rng = np.random.default_rng(1)
    for _ in range(8):
        block = rng.integers(0, 256, size=64, dtype=np.uint8).tobytes()
        assert sh.midstate(block) == ref_sh.midstate(block)
        assert sh.sha256_compress(sh.SHA256_IV, block) == \
            ref_sh.sha256_compress(ref_sh.SHA256_IV, block)
        data = rng.integers(0, 256, size=int(rng.integers(1, 200)),
                            dtype=np.uint8).tobytes()
        assert sh.sha256d(data) == ref_sh.sha256d(data)
        prefix, suffix = data[:37], data[37:]
        assert sh.Sha256Midstate(prefix).sha256d_suffix(suffix) == \
            ref_sh.Sha256Midstate(prefix).sha256d_suffix(suffix)
    assert sh.SHA256_K == ref_sh.SHA256_K and sh.SHA256_IV == ref_sh.SHA256_IV


@pytest.mark.parametrize("nbits", [0x1D00FFFF, 0x207FFFFF, 0x2000FFFF,
                                   0x1B0404CB, 0x03123456, 0x01003456,
                                   0x04923456])
def test_target_functions_match_reference(nbits):
    rng = np.random.default_rng(nbits)
    t = tgt.bits_to_target(nbits)
    assert t == ref_tgt.bits_to_target(nbits)
    assert tgt.target_to_bits(t) == ref_tgt.target_to_bits(t)
    assert np.array_equal(tgt.target_to_limbs(t), ref_tgt.target_to_limbs(t))
    assert tgt.limbs_to_target(tgt.target_to_limbs(t)) == t
    assert tgt.target_to_difficulty(t) == ref_tgt.target_to_difficulty(t)
    for diff in (1, 3, 0.5, 1e-10, 123456.789, 0):
        assert tgt.difficulty_to_target(diff) == ref_tgt.difficulty_to_target(diff)
    for _ in range(4):
        digest = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
        assert tgt.hash_meets_target(digest, t) == ref_tgt.hash_meets_target(digest, t)
        assert tgt.difficulty_of_digest(digest) == ref_tgt.difficulty_of_digest(digest)


# -- (b) plain digest and compare against the jnp twin ----------------------------

def test_sha256d_from_midstate_matches_jnp_twin():
    rng = np.random.default_rng(2)
    for _ in range(3):
        ms, tail = _rand_job(rng)
        nonces = np.concatenate([
            np.array([0, M32, 1, M32 - 1], dtype=np.uint32),
            rng.integers(0, 1 << 32, size=60, dtype=np.uint64).astype(np.uint32),
        ])
        assert np.array_equal(_port_digest_words(ms, tail, nonces),
                              _ref_digest_words(ms, tail, nonces))


def test_sha256d_digest_matches_hashlib():
    rng = np.random.default_rng(3)
    header76 = rng.integers(0, 256, size=76, dtype=np.uint8).tobytes()
    ms = sh.midstate(header76[:64])
    tail = struct.unpack(">3I", header76[64:])
    nonces = np.array([0, 7, M32], dtype=np.uint32)
    d = _port_digest_words(ms, tail, nonces)
    for i, n in enumerate(nonces):
        want = hashlib.sha256(hashlib.sha256(
            header76 + struct.pack(">I", int(n))).digest()).digest()
        assert struct.pack(">8I", *[int(x) for x in d[:, i]]) == want


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_le256_at_hash_boundary_matches_jnp_twin(delta):
    """Targets at a lane's own hash and +-1: the compare is decided on the
    lowest limb, where an off-by-one in the chain would show."""
    rng = np.random.default_rng(4)
    ms, tail = _rand_job(rng)
    nonces = rng.integers(0, 1 << 32, size=32, dtype=np.uint64).astype(np.uint32)
    port_h = st.digest_words_to_compare_order(
        st.sha256d_from_midstate([int(x) for x in ms], [int(x) for x in tail],
                                 torch.as_tensor(nonces.astype(np.int64))))
    ref_d = _ref_digest(tuple(jnp.uint32(x) for x in ms),
                        tuple(jnp.uint32(x) for x in tail),
                        jnp.asarray(nonces), rolled=True)
    ref_h = sj.digest_words_to_compare_order(ref_d)
    for lane in (0, 17, 31):
        hash_int = tgt.limbs_to_target([int(port_h[i][lane]) for i in range(8)])
        limbs = tgt.target_to_limbs(hash_int + delta)
        port_le = st.le256(port_h, [int(x) for x in limbs]).numpy()
        ref_le = np.asarray(sj.le256(ref_h, tuple(limbs)))
        assert np.array_equal(port_le, ref_le)
        assert bool(port_le[lane]) == (delta >= 0)


# -- (c) the kernel's buffer contract against _local_winners_jnp -------------------

def _ref_buf(jw, batch=BATCH, k=K):
    out = _ref_buffer(jnp.asarray(jw[0:8]), jnp.asarray(jw[8:11]),
                      jnp.asarray(jw[12:20]), jnp.uint32(jw[11]),
                      jnp.uint32(jw[20]), jnp.uint32(jw[21]),
                      batch=batch, k=k, rolled=True)
    return np.asarray(out).astype(np.uint32)


def _port_buf(jw, batch=BATCH, k=K):
    return st.sha256d_search_buffer(jw, batch=batch, k=k, device="cpu",
                                    chunk=1024).numpy().view(np.uint32)


def _best_lane_hash(ms, tail, base, count):
    nonces = ((np.arange(count, dtype=np.uint64) + base) & M32).astype(np.uint32)
    h = st.digest_words_to_compare_order(
        st.sha256d_from_midstate([int(x) for x in ms], [int(x) for x in tail],
                                 torch.as_tensor(nonces.astype(np.int64))))
    limbs = torch.stack(h).T.numpy()
    best = int(np.lexsort(limbs.T[::-1])[0])
    return best, tgt.limbs_to_target(limbs[best])


_CASES = {
    # name: (nonce base, in-range count or None, top target limb — or, for
    # best_hash*, the offset of the target from the best lane's hash)
    "few_winners": (123_456_789, None, 1 << 22),
    "ragged_count": (99, BATCH - 1000 - 37, 1 << 23),
    "nonce_wraps": ((1 << 32) - 1500, None, 1 << 23),
    "empty": (5, 0, M32),
    "overflow": (7, None, 1 << 26),
    "best_hash_minus_1": (31337, None, -1),
    "best_hash": (31337, None, 0),
    "best_hash_plus_1": (31337, None, 1),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_search_buffer_matches_local_winners_jnp(case):
    base, count, t = _CASES[case]
    rng = np.random.default_rng(sorted(_CASES).index(case) + 10)
    ms, tail = _rand_job(rng)
    if case.startswith("best_hash"):
        _, best = _best_lane_hash(ms, tail, base, BATCH)
        limbs = tgt.target_to_limbs(best + t)
    else:
        limbs = np.array([t] + [M32] * 7, dtype=np.uint32)
    jw = sc.pack_job_words(ms, tail, base, limbs, count=count)
    assert np.array_equal(jw, sp.pack_job_words(ms, tail, base, limbs,
                                                count=count))
    port, ref = _port_buf(jw), _ref_buf(jw)
    n = int(ref[2 * K])
    if case == "overflow":
        assert n > K
        # past k only the count and the min top limb are defined
        assert port[2 * K] == ref[2 * K] and port[2 * K + 2] == ref[2 * K + 2]
    else:
        assert n <= K
        assert np.array_equal(port, ref), (port.tolist(), ref.tolist())
    expect = {"empty": 0, "best_hash_minus_1": 0, "best_hash": 1,
              "best_hash_plus_1": 1}
    if case in expect:
        assert n == expect[case]


def test_pack_and_unpack_match_reference():
    rng = np.random.default_rng(5)
    ms, tail = _rand_job(rng)
    limbs = rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(np.uint32)
    for count in (None, 0, 1, 4096, 1 << 32):
        assert np.array_equal(
            sc.pack_job_words(ms, tail, (1 << 32) + 5, limbs, count=count),
            sp.pack_job_words(ms, tail, (1 << 32) + 5, limbs, count=count))
    buf = rng.integers(0, 1 << 32, size=sc.winner_buffer_words(K),
                       dtype=np.uint64).astype(np.uint32)
    mine, theirs = sc.unpack_winner_buffer(buf, K), sp.unpack_winner_buffer(buf, K)
    assert np.array_equal(mine[0], theirs[0]) and np.array_equal(mine[1], theirs[1])
    assert mine[2:] == theirs[2:]
    assert sc.JOB_WORDS == sp.JOB_WORDS and sc.K_WINNERS == sp.K_WINNERS


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(6)
    ms, tail = _rand_job(rng)
    jw = sc.pack_job_words(ms, tail, 0, [1 << 24] + [M32] * 7)
    before = sc.launches.value
    out = sc.sha256d_search(jw, batch=BATCH, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.int32
    assert np.array_equal(out.numpy().view(np.uint32), _ref_buf(jw))
    assert sc.launches.value == before  # the kernel never ran


def _rotr_np(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def test_search_params_hoist_the_first_compression_exactly():
    # the kernel's loop from the hoisted words, written out in numpy as
    # csrc/sha256d.cu runs it (round 3's two nonce adds, rounds 4..63 with
    # K[i] + W[i] of W4..W17 and the job-only sums of W18..W33 taken from
    # the parameters), must give the plain rounds' first digest word for
    # word, and digest word 7 of the second hash as the reference's
    # sha256d gives it
    rng = np.random.default_rng(11)
    K = [int(x) for x in sh.SHA256_K]
    s0 = lambda x: _rotr_np(x, 7) ^ _rotr_np(x, 18) ^ (x >> 3)    # noqa: E731
    s1 = lambda x: _rotr_np(x, 17) ^ _rotr_np(x, 19) ^ (x >> 10)  # noqa: E731
    for _ in range(4):
        ms, tail = _rand_job(rng)
        p = sc.search_params(sc.pack_job_words(ms, tail, 0, [M32] * 8))
        assert p.shape == (sc.JOB_WORDS + sc.HOISTED_WORDS,)
        assert p[:sc.JOB_WORDS].tolist() == sc.pack_job_words(
            ms, tail, 0, [M32] * 8).tolist()
        s3, (a4, e4) = p[22:30], p[30:32]
        kw, wc = p[32:46].astype(np.int64), p[46:62].astype(np.int64)
        assert p[62:].tolist() == [1, 1 << 29, 1 << 22]
        n = rng.integers(0, 1 << 32, size=257, dtype=np.int64)
        s = [(int(a4) + n) & M32] + [np.int64(int(x)) for x in s3[:3]] + \
            [(int(e4) + n) & M32] + [np.int64(int(x)) for x in s3[4:7]]
        w = {3: n}
        for i in range(4, 64):
            if i < 18:
                u = s[7] + kw[i - 4]
            else:
                acc = wc[i - 18] if i <= 33 else 0
                for fn, j in ((None, i - 16), (s0, i - 15), (None, i - 7),
                              (s1, i - 2)):
                    if j == 3 or j >= 18:
                        acc = acc + (fn(w[j]) if fn else w[j])
                w[i] = acc & M32
                u = s[7] + w[i] + K[i]
            a, b, c, d, e, f, g, _ = s
            t1 = (u + (_rotr_np(e, 6) ^ _rotr_np(e, 11) ^ _rotr_np(e, 25))
                  + (g ^ (e & (f ^ g)))) & M32
            t2 = ((_rotr_np(a, 2) ^ _rotr_np(a, 13) ^ _rotr_np(a, 22))
                  + ((a & (b | c)) | (b & c))) & M32
            s = [(t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g]
        got = [(int(m) + x) & M32 for m, x in zip(ms, s)]
        tn = torch.as_tensor(n)
        z = torch.tensor(0, dtype=torch.int64)
        want = st.compress(tuple(torch.tensor(int(m)) for m in ms),
                           [torch.tensor(int(x)) for x in tail]
                           + [tn, torch.tensor(0x80000000)] + [z] * 10
                           + [torch.tensor(640)])
        for g_, w_ in zip(got, want):
            assert np.array_equal(np.broadcast_to(g_, n.shape), w_.numpy())
        d7 = _ref_digest_words(ms, tail, n.astype(np.uint32))[7]
        assert np.array_equal(
            _port_digest_words(ms, tail, n.astype(np.uint32))[7], d7)
        second = st.compress(tuple(torch.tensor(v) for v in sh.SHA256_IV),
                             [torch.as_tensor(np.broadcast_to(x, n.shape).copy())
                              for x in got] + [torch.tensor(0x80000000)]
                             + [z] * 6 + [torch.tensor(256)])
        assert np.array_equal(second[7].numpy(), d7)
