"""Port parity, backend level: ``TorchBackend`` on the CPU against the JAX
package's ``XlaBackend``, the bisecting overflow rescan, backend selection
without a card, and the CLI on the CPU.

Jobs are made with numpy from fixed seeds; winners, hashes and the
best-hash telemetry must be identical.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import pytest
import torch

from otedama_tpu.runtime import search as ref_search
from otedama_tpu_torch import cli
from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
from otedama_tpu_torch.kernels import sha256_cuda as sc
from otedama_tpu_torch.kernels import sha256_torch as st
from otedama_tpu_torch.runtime import search

_XLA = ref_search.XlaBackend(chunk=1024, rolled=True)


def _job_pair(seed: int, target: int):
    rng = np.random.default_rng(seed)
    header76 = rng.integers(0, 256, size=76, dtype=np.uint8).tobytes()
    ref = ref_search.JobConstants.from_header_prefix(header76, target)
    port = search.JobConstants.from_header_prefix(header76, target)
    assert port.midstate == ref.midstate and port.tail == ref.tail
    assert np.array_equal(port.limbs, ref.limbs)
    return port, ref


def _same(port: search.SearchResult, ref: ref_search.SearchResult):
    assert [(w.nonce_word, w.digest) for w in port.winners] == \
        [(w.nonce_word, w.digest) for w in ref.winners]
    assert port.hashes == ref.hashes
    assert port.best_hash_hi == ref.best_hash_hi


@pytest.mark.parametrize("case", [
    # (seed, top target limb, base, count)
    (1, 1 << 24, 0, 3072),                # a few winners
    (2, 1 << 24, (1 << 32) - 1000, 2048),  # the window wraps 2^32
    (3, 1 << 24, 12345, 1500),            # ragged count
    (4, 1 << 27, 777, 2048),              # ~64 winners: k=16 overflows, bisect
    (5, 0, 0, 1024),                      # target 0: no winner at all
])
def test_torch_backend_matches_xla_backend(case):
    seed, top, base, count = case
    target = (top << 224) | ((1 << 224) - 1) if top else 0
    port, ref = _job_pair(seed, target)
    before = st.calls.value
    # a fixed table of the kernel's default depth: case 4 must overflow it
    # (without a winner_depth the table is sized from the target)
    got = search.TorchBackend("cpu", chunk=1024,
                              winner_depth=sc.K_WINNERS).search(port, base,
                                                                count)
    want = _XLA.search(ref, base, count)
    _same(got, want)
    if top == 1 << 27:
        assert len(got.winners) > sc.K_WINNERS
        assert st.calls.value - before > 1  # the halves were launched again


def test_search_group_matches_single_searches():
    port, ref = _job_pair(6, (1 << 25 << 224) | ((1 << 224) - 1))
    windows = [(0, 1024), (1024, 1024), (2048, 512)]
    got = search.TorchBackend("cpu").search_group(port, windows)
    for (base, count), r in zip(windows, got):
        _same(r, _XLA.search(ref, base, count))


def test_python_backend_matches():
    port, ref = _job_pair(7, (1 << 26 << 224) | ((1 << 224) - 1))
    _same(search.PythonBackend().search(port, 99, 300),
          ref_search.PythonBackend().search(ref, 99, 300))


def test_collect_drops_a_corrupt_winner(caplog):
    """A winner the host re-check refuses is logged as device corruption
    and dropped, never emitted."""
    port, _ = _job_pair(8, 0)
    backend = search.TorchBackend("cpu")

    def launch_all(jc, windows, k):
        buf = np.zeros((1, sc.winner_buffer_words(k)), dtype=np.uint32)
        buf[0, 0], buf[0, 2 * k] = 42, 1
        return buf

    backend._launch_all = launch_all
    with caplog.at_level("ERROR"):
        res = backend.search(port, 0, 100)
    assert res.winners == [] and "failed host verification" in caplog.text


# -- no card: the card paths raise, they do not fall back ---------------------

def test_card_paths_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less box")
    before = sc.launches.value
    with pytest.raises(RuntimeError, match="is_available"):
        AlgorithmManager("auto").backend_for("sha256d")
    with pytest.raises(RuntimeError, match="is_available"):
        search.CudaBackend("cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        search.CudaBackend("cpu")
    with pytest.raises(Exception):
        sc.sha256d_search(np.zeros(sc.JOB_WORDS, np.uint32), batch=1024,
                          device="cuda")
    assert sc.launches.value == before


def test_explicit_cpu_backends_build():
    mgr = AlgorithmManager("torch", device="cpu")
    assert isinstance(mgr.backend_for("sha256d"), search.TorchBackend)
    assert isinstance(mgr.backend_for("sha256", kind="python"),
                      search.PythonBackend)
    assert isinstance(mgr.backend_for("x11"), search.X11TorchBackend)
    assert isinstance(mgr.backend_for("x11", kind="python"),
                      search.X11NumpyBackend)
    # ethash (ported with ROADMAP A10): every kind is the epoch-managed
    # backend over tiers of that kind
    for kind in ("torch", "python"):
        eth = mgr.backend_for("ethash", kind=kind)
        assert isinstance(eth, search.EthashManagedBackend) and eth.kind == kind
    with pytest.raises(KeyError):  # an algorithm the port does not carry
        mgr.backend_for("kawpow")
    warm = mgr.prepare_backend("sha256d", warm_count=lambda b: 64)
    assert isinstance(warm, search.TorchBackend)


def test_cli_benchmark_on_cpu(capsys):
    assert cli.main(["benchmark", "-a", "sha256d", "-b", "torch",
                     "--device", "cpu", "-n", "2048"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["benchmarks_h_per_s"]["sha256d/torch"] > 0


def test_job_words_encode_the_window():
    port, _ = _job_pair(9, 1 << 200)
    jw = port.job_words((1 << 32) + 3, 10)
    assert jw[11] == 3 and jw[20] == 9 and jw[21] == 0
    assert struct.pack(">3I", *[int(x) for x in jw[8:11]]) == port.header76[64:]
