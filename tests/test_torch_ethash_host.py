"""Port parity, the ethash slice (the host side): the port's host oracle,
``pow_host``'s epoch registry and digests, the certification gate and the
share validator against the JAX package's on the CPU, inputs made from a
seed with numpy, every comparison exact.

- ``hashimoto_light_batch`` (the port's lane-axis host pass) against the
  reference's ``hashimoto_light`` on 2 nonces, ``verify_step`` against
  ``hashimoto_verify_device`` on 16 shares (two forged, count < rows), and
  the composition fingerprint against the reference's;
- ethash registered uncertified, ``etchash`` refused;
- ``register_epoch_cache``'s refusals and its single-flight builds, as the
  reference's tests hold its registry;
- ``share_fields`` (a share's header hash and nonce) against the
  reference's keccak-256 and the big-endian nonce word;
- ``pow_digest`` and ``pow_digests`` against the reference's ``pow_host``,
  and ``ValidationBackend(device="cpu")`` with two miniature epochs in the
  registry: every verdict, one dispatch an epoch.
"""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from otedama_tpu.kernels import ethash as ref
from otedama_tpu.utils import pow_host as ref_pow_host
from otedama_tpu_torch.engine import algos
from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.kernels import ethash_cuda
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.runtime import validate
from otedama_tpu_torch.utils import pow_host

# two miniature epochs: (block number, cache rows, DAG pages)
EPOCHS = {0: (5, 61, 127), 1: (30_007, 67, 131)}


def test_hashimoto_light_batch_matches_hashimoto_light():
    cache = ref.make_cache(61 * ref.HASH_BYTES, ref.seed_hash(0))
    full = 127 * ref.MIX_BYTES
    rng = np.random.default_rng(3)
    hh = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(2)]
    nonces = [0xFFFFFFFF, 0x0123456789ABCDEF]
    mix, res = eth.hashimoto_light_batch(full, cache, hh, nonces)
    for i in range(2):
        want = ref.hashimoto_light(full, cache, hh[i], nonces[i])
        assert (mix[i].tobytes(), res[i].tobytes()) == want
    # one header hash for every nonce: the same rows as one per nonce
    mix1, res1 = eth.hashimoto_light_batch(full, cache, hh[0], nonces)
    mix2, res2 = eth.hashimoto_light_batch(full, cache, [hh[0]] * 2, nonces)
    assert np.array_equal(mix1, mix2) and np.array_equal(res1, res2)
    assert np.array_equal(res1[0], res[0])


def test_verify_step_matches_reference():
    """``verify_step`` (through the wrapper, on CPU tensors) against
    ``hashimoto_verify_device`` on 16 shares, two forged, count < rows, on
    the reference's native-built cache carried across."""
    cache = ref.make_cache(251 * ref.HASH_BYTES, ref.seed_hash(0))
    cache_t, _ = ethash_cuda.epoch_tensors(cache, "cpu")
    rng = np.random.default_rng(21)
    hhs = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 32, 16, dtype=np.uint64)
    _, res = eth.hashimoto_light_batch(509 * 128, cache, hhs, nonces)
    vals = [int.from_bytes(r.tobytes(), "big") for r in res]
    forged = {3, 11}
    limbs = np.stack([tgt.target_to_limbs(v - 1 if i in forged else v + i % 3)
                      for i, v in enumerate(vals)])
    count = 14
    want = ref.hashimoto_verify_device(509 * 128, cache, hhs, nonces, limbs,
                                       count, 16)
    rows_h, rows_n = ethash_cuda.share_rows(hhs, nonces)
    parts = [torch.from_numpy(x.view(np.int32)) for x in (rows_h, rows_n, limbs)]
    got = ethash_cuda.ethash_verify(509 * 128, cache_t, *parts, count, k=16)
    assert got.numpy().view(np.uint32).tolist() == want.tolist()
    assert want[:2].tolist() == [3, 11] and want[32] == 2
    assert want[34] == min(v >> 224 for v in vals[:count])


def test_composition_fingerprint_matches_reference():
    assert eth.composition_fingerprint() == ref.composition_fingerprint()


def test_ethash_registered_uncertified_and_etchash_refused():
    spec = algos.get("ethash")
    assert spec.canonical is False and spec.memory_hard
    assert spec.backends == ("cuda", "torch", "python")
    assert eth._maybe_certify() is False      # no artifact here
    with pytest.raises(ValueError, match="not certified canonical"):
        algos.get("etchash")
    with pytest.raises(ValueError, match="not certified canonical"):
        pow_host.pow_digest(bytes(80), "etchash")
    assert not algos.supports("etchash", "cuda") and algos.implemented("ethash")


@pytest.fixture
def registry():
    """The port's epoch registry emptied for a test and restored after."""
    saved = dict(pow_host._ETHASH_CACHES)
    pow_host._ETHASH_CACHES.clear()
    try:
        yield pow_host._ETHASH_CACHES
    finally:
        pow_host._ETHASH_CACHES.clear()
        pow_host._ETHASH_CACHES.update(saved)


def test_register_epoch_cache_refuses_noncanonical_sizing(registry):
    mini = ref.make_cache(64 * eth.HASH_BYTES, eth.seed_hash(0))
    # miniature sizing: refused (the registry is real-chain-keyed)
    assert not pow_host.register_epoch_cache(0, 32 * eth.MIX_BYTES, mini)
    assert 0 not in registry
    # wrong full_size against a real cache row count: refused
    rows = eth.cache_size(0) // eth.HASH_BYTES
    fake = np.zeros((rows, 16), dtype=np.uint32)
    assert not pow_host.register_epoch_cache(
        0, eth.dataset_size(0) + eth.MIX_BYTES, fake)
    # canonical sizing: adopted exactly once, the first donation wins
    assert pow_host.register_epoch_cache(0, eth.dataset_size(0), fake)
    assert registry[0][1] is fake
    other = np.zeros((rows, 16), dtype=np.uint32)
    assert pow_host.register_epoch_cache(0, eth.dataset_size(0), other)
    assert registry[0][1] is fake
    # at most two epochs stay: the oldest goes
    for epoch in (3, 5):
        bn = epoch * eth.EPOCH_LENGTH
        pow_host.register_epoch_cache(
            epoch, eth.dataset_size(bn),
            np.zeros((eth.cache_size(bn) // eth.HASH_BYTES, 16), np.uint32))
    assert sorted(registry) == [3, 5]


def test_epoch_cache_concurrent_builders_build_once(registry, monkeypatch):
    builds = []

    def fake_make_cache(size, seed, device="cuda"):
        builds.append(size)
        time.sleep(0.05)
        return "CACHE"

    monkeypatch.setattr(eth, "make_cache", fake_make_cache)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(pow_host._epoch_cache(7)))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(results) == 4
    assert all(r == (eth.dataset_size(7 * eth.EPOCH_LENGTH), "CACHE")
               for r in results)
    assert not pow_host._ETHASH_BUILDING


@pytest.fixture
def mini_epochs(registry):
    """Both packages' registries hold the two miniature epochs (the
    reference's native-built caches): {epoch: (block, full_size, cache)}."""
    saved = dict(ref_pow_host._ETHASH_CACHES)
    out = {}
    for epoch, (bn, rows, pages) in EPOCHS.items():
        cache = ref.make_cache(rows * ref.HASH_BYTES, ref.seed_hash(0))
        full = pages * ref.MIX_BYTES
        registry[epoch] = (full, cache)
        ref_pow_host._ETHASH_CACHES[epoch] = (full, cache)
        out[epoch] = (bn, full, cache)
    try:
        yield out
    finally:
        ref_pow_host._ETHASH_CACHES.clear()
        ref_pow_host._ETHASH_CACHES.update(saved)


def _headers(seed: int, n: int) -> list[bytes]:
    rows = np.random.default_rng(seed).integers(0, 256, (n, 80), dtype=np.uint8)
    return [r.tobytes() for r in rows]


def test_share_fields_follow_the_framework_layout():
    """One rule turns a share's 80 bytes into ethash's inputs (the
    search's header hash, ``pow_host`` and the validator use it): the
    reference's keccak-256 of the 76-byte prefix, and the big-endian nonce
    word at bytes 76:80."""
    headers = _headers(21, 5)
    want_hh = [ref.keccak256(h[:76]) for h in headers]
    want_n = [int.from_bytes(h[76:], "big") for h in headers]
    rows = np.frombuffer(b"".join(headers), np.uint8).reshape(5, 80)
    for form in (headers, b"".join(headers), rows):
        hh, nonces = eth.share_fields(form)
        assert [r.tobytes() for r in hh] == want_hh
        assert nonces.dtype == np.uint64 and nonces.tolist() == want_n
    assert eth.header_hash(headers[0]) == want_hh[0]


def test_pow_digests_match_the_references_pow_host(mini_epochs):
    for epoch, (bn, full, cache) in mini_epochs.items():
        headers = _headers(epoch + 1, 6)
        got = pow_host.pow_digests(headers, "ethash", bn)
        # the conventions: keccak-256 of the 76-byte prefix, the big-endian
        # nonce word, the result byte-reversed
        _, res = eth.hashimoto_light_batch(
            full, cache, [eth.keccak256(h[:76]) for h in headers],
            [int.from_bytes(h[76:], "big") for h in headers])
        assert got == [r[::-1].tobytes() for r in res]
        assert pow_host.pow_digest(headers[0], "ethash", bn) == got[0]
        # one host digest of the reference (~2 s each)
        assert ref_pow_host.pow_digest(headers[1], "ethash", bn) == got[1]


def test_validation_backend_two_epochs_two_dispatches(mini_epochs):
    checks, want = [], []
    for epoch, (bn, _, _) in mini_epochs.items():
        headers = _headers(10 + epoch, 8)
        digests = pow_host.pow_digests(headers, "ethash", bn)
        for i, (h, d) in enumerate(zip(headers, digests)):
            v = int.from_bytes(d, "little")
            forged = i in (2, 5)
            checks.append(validate.ShareCheck(h, v - 1 if forged else v + i,
                                              "ethash", bn))
            want.append(not forged)
    # the two epochs interleaved in one batch
    order = [i // 2 + 8 * (i % 2) for i in range(16)]
    checks = [checks[i] for i in order]
    want = [want[i] for i in order]
    vb = validate.ValidationBackend(device="cpu", min_batch=1,
                                    tripwire_rate=0.3, seed=4)
    assert asyncio.run(vb.verify_batch(checks)) == want
    snap = vb.snapshot()
    assert snap["device_batches"] == 2 and snap["validated_device"] == 16
    assert snap["tripwire_mismatches"] == 0 and snap["rejects"] == 4
    assert sorted(vb._eth_caches) == [0, 1]
    # a share's buffer: failures of the epoch's 8, its offsets and count
    buf = vb._device_buffer("ethash", checks[0::2], vb.k)
    assert buf[:2].tolist() == [2, 5] and buf[2 * vb.k] == 2
    # under the crossover the host path judges the same
    host = validate.ValidationBackend(device=None)
    assert asyncio.run(host.verify_batch(checks)) == want
    assert tgt.hash_meets_target(
        pow_host.pow_digest(checks[0].header, "ethash", checks[0].block_number),
        checks[0].target) == want[0]
