"""Port parity, the ethash slice (the one-epoch backends and the solo
application), on the CPU against the JAX package:

- ``EthashTorchBackend(device="cpu")`` (light and full) against the
  reference's ``EthashLightBackend(device=True, cache_rows=251,
  full_pages=509, chunk=64)``; its bisect against the numpy tier's dense
  pass; a corrupt device winner dropped by the host re-check;
- ``make_backend`` and ``AlgorithmManager`` for ethash;
- the port's solo ``Application`` mining ethash through the epoch-managed
  backend's torch tiers (miniature sizing: a real epoch's cache is about
  an hour of the python chain), every block candidate re-checked.
"""

from __future__ import annotations

import asyncio
import functools
import time

import numpy as np
import pytest

from otedama_tpu.kernels import ethash as ref
from otedama_tpu.runtime import search as ref_search
from otedama_tpu_torch.app import Application
from otedama_tpu_torch.config.schema import load_config
from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.pool.blockchain import MockChainClient
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


def _values(full: int, cache, header76: bytes, base: int, count: int):
    nonces = (base + np.arange(count, dtype=np.uint64)) & M32
    _, res = eth.hashimoto_light_batch(full, cache, eth.keccak256(header76),
                                       nonces)
    return [int.from_bytes(r.tobytes(), "big") for r in res]


def test_torch_backend_matches_the_references_light_backend():
    header76, base, count = _prefix(1), (1 << 32) - 30, 64
    rows, pages = 251, 509
    cache = ref.make_cache(rows * ref.HASH_BYTES, ref.seed_hash(0))
    vals = sorted(_values(pages * 128, cache, header76, base, count))
    target = vals[0]                                 # exactly one winner
    want = ref_search.EthashLightBackend(
        device=True, cache_rows=rows, full_pages=pages, chunk=64).search(
        ref_search.JobConstants.from_header_prefix(header76, target),
        base, count)
    jc = search.JobConstants.from_header_prefix(header76, target)
    for full in (False, True):
        got = search.EthashTorchBackend("cpu", cache_rows=rows,
                                        full_pages=pages, cache=cache,
                                        full_dataset=full).search(jc, base, count)
        assert _rows(got) == _rows(want) and len(got.winners) == 1
    # a full tier with a 2-slot table bisects an overflowing window: the
    # winners of the numpy tier's dense pass
    jc9 = search.JobConstants.from_header_prefix(header76, vals[8])
    dense = search.EthashNumpyBackend(cache_rows=rows, full_pages=pages,
                                      cache=cache).search(jc9, base, count)
    got = search.EthashTorchBackend("cpu", winner_depth=2, cache_rows=rows,
                                    full_pages=pages, cache=cache,
                                    full_dataset=True).search(jc9, base, count)
    assert len(dense.winners) == 9 and _rows(got) == _rows(dense)


def test_a_corrupt_ethash_winner_is_dropped(caplog):
    jc = search.JobConstants.from_header_prefix(_prefix(2), 1 << 200)
    backend = search.EthashTorchBackend("cpu", cache_rows=61, full_pages=127,
                                        cache=ref.make_cache(61 * 64,
                                                             ref.seed_hash(0)))

    def launch_eth(jc, windows, k):
        buf = np.zeros((1, 2 * k + 3), dtype=np.uint32)
        buf[0, 0], buf[0, 2 * k] = 5, 1
        return buf

    backend._launch_eth = launch_eth
    with caplog.at_level("ERROR"):
        res = backend.search(jc, 0, 10)
    assert res.winners == [] and "failed host verification" in caplog.text


def test_make_backend_and_the_algorithm_manager():
    for kind in ("torch", "python"):
        b = search.make_backend(kind, "ethash", device="cpu", winner_depth=4)
        assert isinstance(b, search.EthashManagedBackend) and b.kind == kind
        assert b.name == "ethash-managed" and not b.full_dataset
    with pytest.raises(ValueError, match="no DAG"):
        search.EthashManagedBackend("python", full_dataset=True)
    b = AlgorithmManager("torch", device="cpu").backend_for("ethash")
    assert b.kind == "torch" and b.device.type == "cpu" and b.max_batch == 256


@pytest.mark.asyncio
async def test_solo_application_mines_ethash_on_cpu(tmp_path, monkeypatch):
    """The port's ``Application`` on ``mining.algorithm: ethash`` through
    the managed backend's torch tiers (miniature sizing: a real epoch's
    cache is an hour of the python chain), the template's height in every
    job."""
    monkeypatch.setitem(search._BACKENDS["ethash"], "torch", functools.partial(
        search.EthashManagedBackend, "torch", sizing=_sizing,
        full_dataset=True, chunk=32))
    path = tmp_path / "cfg.yaml"
    path.write_text("mining:\n  algorithm: ethash\n  backend: torch\n"
                    "  device: cpu\n  batch_size: 32\n  pipeline_depth: 1\n"
                    "work:\n  enabled: true\n  poll_seconds: 0.05\n")
    cfg = load_config(str(path))
    assert cfg.mining.algorithm == "ethash"
    chain = MockChainClient(nbits=0x207FFFFF)   # half of all hashes win
    app = Application(cfg, chain=chain)
    submitted = []
    submit = chain.submit_block

    async def record(header):
        outcome = await submit(header)
        submitted.append((chain.height, header, outcome))
        return outcome

    chain.submit_block = record
    await app.start()
    try:
        deadline = time.monotonic() + 60.0
        while len(submitted) < 3:
            assert time.monotonic() < deadline, app.snapshot()
            await asyncio.sleep(0.02)
    finally:
        await app.stop()
    target = 0x7FFFFF << (8 * (0x20 - 3))
    (backend,) = app.engine.backends.values()
    assert isinstance(backend, search.EthashManagedBackend)
    assert backend.snapshot()["live_epoch"] == 0
    rows, pages = MINI[0]
    cache = ref.make_cache(rows * ref.HASH_BYTES, ref.seed_hash(0))
    for _, header, outcome in submitted:
        # an ethash block candidate: its ethash digest meets the target;
        # the mock chain checks blocks by sha256d
        _, res = eth.hashimoto_light_batch(
            pages * 128, cache, eth.keccak256(header[:76]),
            [int.from_bytes(header[76:], "big")])
        assert int.from_bytes(res[0].tobytes(), "big") <= target
        assert outcome.accepted == (
            int.from_bytes(pow_host.sha256d(header), "little") <= target)
    snap = app.snapshot()["engine"]
    assert snap["algorithm"] == "ethash" and snap["shares"]["found"] >= 3
