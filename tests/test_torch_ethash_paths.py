"""Port parity, the ethash slice (the epoch lifecycle): the port's
``EthashManagedBackend`` on torch tiers across epoch boundaries (a
prefetched epoch, one that is not, the DAG built in the background, an
eviction), each epoch's winners against the reference's light step. The
one-epoch backends and the solo application: ``test_torch_ethash_app.py``.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import pytest

from otedama_tpu.kernels import ethash as ref
from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.runtime import search
from otedama_tpu_torch.utils import pow_host

M32 = 0xFFFFFFFF
# miniature epochs: epoch -> (cache rows, DAG pages)
MINI = {0: (61, 127), 1: (67, 131), 2: (71, 137)}


def _sizing(epoch: int) -> dict:
    rows, pages = MINI[epoch % 3]
    return {"cache_rows": rows, "full_pages": pages}


def _prefix(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


def _rows(res):
    return ([(w.nonce_word, w.digest) for w in res.winners], res.hashes,
            res.best_hash_hi)


def _wait(cond, timeout: float = 30.0) -> None:
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "timed out"
        time.sleep(0.02)


def test_managed_backend_follows_the_jobs_across_epochs(monkeypatch):
    monkeypatch.setattr(search, "ETHASH_LIGHT_LANES", 32)
    managed = search.EthashManagedBackend(
        "torch", device="cpu", full_dataset=True, sizing=_sizing, chunk=64)
    header76 = _prefix(3)
    caches = {e: ref.make_cache(r * ref.HASH_BYTES, ref.seed_hash(0))
              for e, (r, _) in MINI.items()}

    def check(block: int, base: int, res, lanes: int):
        """the reference's light step over the window's first ``lanes`` of
        64 (one shape: one compile)"""
        epoch = block // eth.EPOCH_LENGTH
        rows, pages = MINI[epoch]
        limbs = search.JobConstants.from_header_prefix(header76, TARGET).limbs
        nonces = (base + np.arange(64, dtype=np.uint64)) & M32
        want = ref.hashimoto_winners_device(
            pages * 128, caches[epoch], eth.keccak256(header76), nonces, limbs,
            lanes, 16)
        assert res.hashes == lanes
        assert [w.nonce_word for w in res.winners] == \
            [(base + int(o)) & M32 for o in want[:int(want[32])]]
        assert res.best_hash_hi == int(want[34])

    TARGET = (1 << 253) - 1                            # ~1 lane in 8 wins
    jc = functools.partial(search.JobConstants.from_header_prefix, header76,
                           TARGET)
    # epoch 0, near the boundary: the light tier at once (the window cut to
    # 32 lanes), the next epoch prefetched, both DAGs built behind it
    res = managed.search(jc(block_number=29_990), 0, 64)
    check(29_990, 0, res, 32)
    _wait(lambda: managed.snapshot()["full_epochs"] == [0, 1])
    res = managed.search(jc(block_number=29_990), 64, 64)
    dense = search.EthashNumpyBackend(cache=caches[0], **_sizing(0)).search(
        jc(block_number=29_990), 64, 64)
    assert _rows(res) == _rows(dense)
    # epoch 1 mined on its full tier from its first job
    res = managed.search(jc(block_number=30_005), 128, 64)
    check(30_005, 128, res, 64)
    snap = managed.snapshot()
    assert snap["live_epoch"] == 1 and snap["full_calls"] == 2
    assert snap["light_calls"] == 1 and snap["build_failures"] == 0
    # epoch 2, not prefetched: light first, then full; epoch 0 evicted
    res = managed.search(jc(block_number=60_005), 192, 64)
    check(60_005, 192, res, 32)
    _wait(lambda: managed.snapshot()["full_epochs"] == [1, 2])
    snap = managed.snapshot()
    assert snap["evictions"] == 1 and snap["light_epochs"] == [0, 1, 2]
    assert snap["full_upgrades"] == 3 and snap["build_failures"] == 0
    # miniature sizings are not donated to the validator's registry
    assert not set(pow_host._ETHASH_CACHES) & {0, 1, 2} or all(
        pow_host._ETHASH_CACHES[e][0] == eth.dataset_size(e * 30000)
        for e in set(pow_host._ETHASH_CACHES) & {0, 1, 2})
    managed.close()
    with pytest.raises(search.BackendClosedError):
        managed.search(jc(block_number=60_005), 0, 8)
