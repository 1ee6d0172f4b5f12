"""Port parity, the x11 slice: the port's x11 modules against the JAX
package's on the CPU.

- the copied host-tier stage modules, stage by stage, and their constants;
- the plain PyTorch chain (``x11_torch``, the design of kernel B6) against
  the reference's ``x11_digest_batch`` on 8 seeded headers and the Dash
  genesis header, under each of the five shavite counter orders;
- the plain winner buffer against ONE eager call of the reference's
  ``jnp_chain.x11_winner_step`` (a module fixture: an eager chain costs
  tens of seconds on this CPU whatever its lanes; no other jnp chain call
  is made), and the plain failure buffer
  against ``digest_limbs``, ``le256`` and ``compact_failures`` fed with the
  oracle's digests;
- the search backends, ``pow_digest``, the share validator, and a solo
  ``Application`` mining x11 on the CPU;
- the kernel source's constant literals and table layout against the
  port's host tier (the kernels themselves run only on the card:
  ``chip_smoke.py`` phases 29–33; their table forms, lookups, simd's NTT
  and the launch sequence's chunks: ``test_torch_x11_tables.py``).
"""

from __future__ import annotations

import asyncio
import functools
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from otedama_tpu.kernels import sha256_jax as ref_sj
from otedama_tpu.kernels import x11 as ref_x11
from otedama_tpu.kernels.x11 import jnp_chain
from otedama_tpu.kernels.x11 import shavite as ref_shavite
from otedama_tpu.runtime import validate as ref_validate
from otedama_tpu.utils import jaxcompat
from otedama_tpu.utils import pow_host as ref_pow_host
from otedama_tpu_torch.app import Application
from otedama_tpu_torch.config.schema import load_config
from otedama_tpu_torch.engine import algos
from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
from otedama_tpu_torch.kernels import x11 as port_x11
from otedama_tpu_torch.kernels import x11_cuda, x11_torch
from otedama_tpu_torch.kernels.x11 import shavite as port_shavite
from otedama_tpu_torch.pool.blockchain import MockChainClient
from otedama_tpu_torch.runtime import search, validate
from otedama_tpu_torch.utils import pow_host

M32 = 0xFFFFFFFF
REPO = Path(__file__).resolve().parents[1]
VARIANTS = tuple(ref_shavite.CNT_VARIANTS)


def _headers(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, 80),
                                                dtype=np.uint8)


def _ref_digests(headers: np.ndarray, variant: str) -> np.ndarray:
    prev = ref_shavite.active_cnt_variant()
    ref_shavite.set_cnt_variant(variant)
    try:
        return ref_x11.x11_digest_batch(headers)
    finally:
        ref_shavite.set_cnt_variant(prev)


def _words(headers: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x11_torch.headers_to_words(headers).astype(np.int64))


def _value(digest: bytes) -> int:
    return int.from_bytes(bytes(digest), "little")


# -- the host tier: the port's own copies ----------------------------------------

@pytest.mark.parametrize("name", ref_x11.ORDER)
def test_stage_module_matches_reference(name):
    rng = np.random.default_rng(len(name))
    for n in (0, 1, 64, 80, 111, 200):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert port_x11.STAGES_BYTES[name](data) == \
            ref_x11.STAGES_BYTES[name](data), (name, n)


@pytest.mark.parametrize("variant", VARIANTS)
def test_shavite_under_every_counter_variant(variant):
    rng = np.random.default_rng(11)
    msgs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in (64, 130)]
    prev = (port_shavite.active_cnt_variant(), ref_shavite.active_cnt_variant())
    port_shavite.set_cnt_variant(variant)
    ref_shavite.set_cnt_variant(variant)
    try:
        got = [port_shavite.shavite512_bytes(m) for m in msgs]
        want = [ref_shavite.shavite512_bytes(m) for m in msgs]
    finally:
        port_shavite.set_cnt_variant(prev[0])
        ref_shavite.set_cnt_variant(prev[1])
    assert got == want
    pairs = list(zip(msgs, want))
    assert port_shavite.select_cnt_variant(pairs) == \
        ref_shavite.select_cnt_variant(pairs)


def test_copied_constants_are_equal():
    from otedama_tpu.kernels import x11 as r
    from otedama_tpu_torch.kernels import x11 as p

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for key in a:
                same(a[key], b[key])
        else:
            assert np.array_equal(np.asarray(a, dtype=object),
                                  np.asarray(b, dtype=object))

    for mod, names in {
        "blake": ("C512", "IV512", "SIGMA"),
        "bmw": ("IV512", "FINAL512", "_R", "_W_TERMS"),
        "groestl": ("_SHIFT_P", "_SHIFT_Q", "_MIX"),
        "skein": ("C240", "R512", "PERM", "IV512", "T_MSG", "T_OUT"),
        "jh": ("S0", "S1", "_MUL2"),
        "keccak": ("RC", "RHO", "RATE_512"),
        "luffa": ("IV", "CNS"),
        "shavite": ("IV512", "ROUNDS", "RK_WORDS", "CNT_VARIANTS"),
        "simd": ("IV512", "WSP", "ROUND_ROTS", "FF_ROTS", "PMASK"),
        "echo": ("_AES_SHIFT", "_BIG_SHIFT"),
    }.items():
        for name in names:
            same(getattr(getattr(p, mod), name), getattr(getattr(r, mod), name))
    same(p.groestl.aes_sbox(), r.groestl.aes_sbox())
    same(p.groestl._gf_tables(), r.groestl._gf_tables())
    same(p.jh.round_constants(), r.jh.round_constants())
    same(p.jh._iv512(), r.jh._iv512())
    same(p.cubehash._iv512(), r.cubehash._iv512())
    same(p.simd._twist_tables(), r.simd._twist_tables())
    same(p.simd._ntt_matrix(), r.simd._ntt_matrix())
    assert p.ORDER == r.ORDER
    assert p.DASH_GENESIS_HEADER == r.DASH_GENESIS_HEADER
    assert p.DASH_GENESIS_ORACLES == r.DASH_GENESIS_ORACLES
    assert p.shavite.active_cnt_variant() == r.shavite.active_cnt_variant()


def test_x11_stays_uncertified_and_dash_refuses():
    spec = algos.get("x11")
    assert spec.canonical is False and spec.chained == 11
    assert spec.backends == ("cuda", "torch", "python")
    assert port_x11._maybe_certify() is False   # no artifact here
    with pytest.raises(ValueError, match="not certified canonical"):
        algos.get("dash")
    assert not algos.supports("dash", "cuda") and algos.implemented("x11")


# -- the plain chain against the reference ------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_chain_matches_reference(variant):
    headers = _headers(20261018, 8)
    headers = np.concatenate([
        headers, np.frombuffer(ref_x11.DASH_GENESIS_HEADER, np.uint8)[None]])
    got = x11_torch.x11_digest_chain(headers, cnt_variant=variant)
    want = _ref_digests(headers, variant)
    assert np.array_equal(got, want)
    if variant == port_shavite.active_cnt_variant():
        assert np.array_equal(port_x11.x11_digest_batch(headers), want)
        assert port_x11.x11_digest(ref_x11.DASH_GENESIS_HEADER) == \
            ref_x11.x11_digest(ref_x11.DASH_GENESIS_HEADER)


@pytest.fixture(scope="module")
def jnp_winner_step():
    """ONE eager call of the reference's device step on 5 headers, a target
    planted between the lanes' digests so that some win, and the last lane
    clamped out of range: (headers, digests, limbs, last, k, target, its
    buffer)."""
    import jax.numpy as jnp

    headers = _headers(7, 5)
    variant = port_shavite.active_cnt_variant()
    digests = _ref_digests(headers, variant)
    values = sorted(_value(d) for d in digests[:4])
    target = values[2]                       # three of the four in range win
    limbs = [int(x) for x in
             np.asarray([(target >> (224 - 32 * j)) & M32 for j in range(8)],
                        dtype=np.uint32)]
    k, last = 2, 3                           # three winners overflow k = 2
    with jaxcompat.enable_x64():
        want = np.asarray(jnp_chain.x11_winner_step(
            jnp.asarray(headers), jnp.asarray(np.asarray(limbs, np.uint32)),
            jnp.uint32(last), k=k, sbox_mode="table",
            cnt_variant=variant)).astype(np.int64)
    return headers, digests, limbs, last, k, target, want


def test_plain_winner_buffer_matches_the_jnp_winner_step(jnp_winner_step):
    headers, digests, limbs, last, k, target, want = jnp_winner_step
    got = x11_torch.x11_winner_step(_words(headers), limbs, last, k=k)
    assert got.tolist() == want.tolist()
    assert want[2 * k] == 3
    # and with a table deep enough, the same compaction in lane order
    assert x11_torch.x11_winner_step(_words(headers), limbs, last,
                                     k=8)[:3].tolist() == sorted(
        i for i in range(4) if _value(digests[i]) <= target)


@functools.lru_cache(maxsize=1)
def _failure_rows():
    headers = _headers(30, 24)
    return headers, _ref_digests(headers, port_shavite.active_cnt_variant())


@pytest.mark.parametrize("count", [1, 11, 24])
def test_plain_failure_buffer_matches_reference_compaction(count):
    """``x11_verify_step`` minus the chain: the reference's
    ``digest_limbs``, ``le256`` and ``compact_failures`` fed with the
    oracle's digests, word for word, each share against its own
    target."""
    headers, d = _failure_rows()
    rng = np.random.default_rng(count)
    targets = [_value(x) + int(rng.integers(-1, 2)) for x in d]
    targets = [max(0, t) for t in targets]
    limbs = np.stack([np.asarray([(t >> (224 - 32 * j)) & M32
                                  for j in range(8)], dtype=np.uint32)
                      for t in targets])
    h = jnp_chain.digest_limbs(d)
    passes = ref_sj.le256(h, tuple(limbs[:, i] for i in range(8)))
    want = np.asarray(ref_sj.compact_failures(passes, h[0], np.uint32(
        (count - 1) & M32), 6)).view(np.int32)
    got = x11_cuda.x11_verify(torch.from_numpy(_words(headers).numpy()
                                               .astype(np.uint32).view(np.int32)),
                              torch.from_numpy(limbs.view(np.int32)), count,
                              k=6)
    assert got.tolist() == want.tolist()


# -- the backends ---------------------------------------------------------------

def _jc(seed: int, top: int):
    header76 = np.random.default_rng(seed).integers(
        0, 256, size=76, dtype=np.uint8).tobytes()
    return search.JobConstants.from_header_prefix(
        header76, (top << 224) | ((1 << 224) - 1))


def _rows(res):
    return ([(w.nonce_word, w.digest) for w in res.winners], res.hashes,
            res.best_hash_hi)


@pytest.mark.parametrize("case", [
    # (seed, top target limb, base, count)
    (1, 1 << 28, 1000, 48),               # a few planted winners
    (2, 1 << 28, (1 << 32) - 20, 40),     # the window wraps 2^32
    (3, 1 << 30, 77, 37),                 # ~9 winners: k = 4 overflows, bisect
])
def test_torch_backend_matches_the_numpy_backend(case):
    seed, top, base, count = case
    jc = _jc(seed, top)
    dense = search.X11NumpyBackend(chunk=64).search(jc, base, count)
    assert dense.winners
    got = search.X11TorchBackend("cpu", winner_depth=4).search(jc, base, count)
    assert _rows(got) == _rows(dense)
    want = ref_x11.x11_digest_batch(np.stack([
        np.frombuffer(jc.header_for(w.nonce_word), np.uint8)
        for w in got.winners]))
    assert [w.digest for w in got.winners] == [d.tobytes() for d in want]
    if seed == 3:
        assert len(got.winners) > 4
    if seed == 2:
        # the count clamps: a window one lane short (it still wraps)
        # finds the winners before it
        short = search.X11TorchBackend("cpu").search(jc, base, count - 1)
        assert _rows(short)[0] == [r for r in _rows(dense)[0]
                                   if (r[0] - base) & M32 < count - 1]


def test_a_groups_winners_are_rechecked_in_one_host_pass(monkeypatch):
    """The winners of every window of a group, those of a bisected window
    among them, go through ONE pass of the host chain."""
    jc = _jc(3, 1 << 30)
    windows = [(77, 37), (114, 20)]
    passes = []
    digests = pow_host.pow_digests

    def counted(headers, algorithm, *args):
        passes.append(len(headers))
        return digests(headers, algorithm, *args)

    monkeypatch.setattr(pow_host, "pow_digests", counted)
    got = search.X11TorchBackend("cpu", winner_depth=4).search_group(
        jc, windows)
    dense = [search.X11NumpyBackend(chunk=64).search(jc, base, count)
             for base, count in windows]
    assert [_rows(r) for r in got] == [_rows(r) for r in dense]
    assert len(got[0].winners) > 4 and got[1].winners
    assert passes == [sum(len(r.winners) for r in got)]


def test_collect_drops_a_corrupt_x11_winner(caplog):
    jc = _jc(4, 0)
    backend = search.X11TorchBackend("cpu")

    def launch_x11(jc, windows, k):
        buf = np.zeros((1, 2 * k + 3), dtype=np.uint32)
        buf[0, 0], buf[0, 2 * k] = 5, 1
        return buf

    backend._launch_x11 = launch_x11
    with caplog.at_level("ERROR"):
        res = backend.search(jc, 0, 10)
    assert res.winners == [] and "failed host verification" in caplog.text


def test_card_paths_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less box")
    before = (x11_cuda.search_launches.value, x11_cuda.verify_launches.value)
    with pytest.raises(RuntimeError, match="is_available"):
        search.X11CudaBackend("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        AlgorithmManager("auto").backend_for("x11")
    with pytest.raises(Exception):
        x11_cuda.x11_search(bytes(76), 0, 63, [0] * 8, batch=64, k=4,
                            device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        x11_cuda.load_library()
    with pytest.raises(RuntimeError, match="is_available"):
        validate.ValidationBackend()
    assert (x11_cuda.search_launches.value,
            x11_cuda.verify_launches.value) == before


def test_kernel_source_constants_match_the_host_tier():
    """The literals of ``csrc/x11.cu`` and its table-block offsets are the
    port's host tier's constants (the kernels read nothing else; the
    table block's contents: ``test_torch_x11_tables.py``)."""
    src = (REPO / "otedama_tpu_torch/kernels/csrc/x11.cu").read_text()

    def literal(name):
        body = re.search(rf"__constant__ \w+ {name}(?:\[\d+\])+ = \{{(.*?)\}};",
                         src, re.S).group(1)
        return [int(v.rstrip("ul"), 16) for v in re.findall(r"0x[0-9A-Fa-f]+u?l*", body)]

    from otedama_tpu_torch.kernels.x11 import blake, keccak, luffa, simd, skein
    assert literal("kBlakeIV") == [int(v) for v in blake.IV512]
    assert literal("kBlakeC") == [int(v) for v in blake.C512]
    assert literal("kSkeinIV") == list(skein.IV512)
    assert literal("kKeccakRC") == [int(v) for v in keccak.RC]
    assert literal("kLuffaIV") == [int(v) for v in luffa.IV.reshape(-1)]
    assert literal("kLuffaCNS") == [v for j in luffa.CNS for s in j for v in s]
    assert literal("kShaviteIV") == list(port_shavite.IV512)
    assert literal("kSimdIV") == list(simd.IV512)
    w8 = re.search(r"__constant__ int kW8\[32\] = \{(.*?)\};", src, re.S).group(1)
    assert [int(v) for v in w8.replace(",", " ").split()] == \
        [pow(41, 8 * e, 257) for e in range(32)]
    offsets = dict(re.findall(r"constexpr int k(\w+)Off = (\d+);", src))
    at = 0
    starts = {}
    for name, n in x11_cuda.TABLE_LAYOUT:
        starts[name] = at
        at += n
    assert starts == x11_cuda.table_offsets()
    assert {k: int(v) for k, v in offsets.items()} == {
        "Gro": starts["groestl"], "Aes": starts["aes"],
        "JhIv": starts["jh_iv"], "JhC": starts["jh_c"],
        "CubeIv": starts["cube_iv"], "SimdC": starts["simd_c"],
        "Twist": starts["twist"], "WFinal": starts["w_final"]}
    assert f"kTableWords = {x11_cuda.TABLE_WORDS};" in src
    assert x11_cuda.table_block().shape == (x11_cuda.TABLE_WORDS,)
    assert x11_cuda.pack_cnt_order(x11_torch.cnt_variant_order("identity")) \
        == sum(j << (2 * (4 * i + j)) for i in range(4) for j in range(4))


# -- pow_host, validation, the solo application --------------------------------

def test_pow_digest_x11_equal_and_dash_refused():
    header = ref_x11.DASH_GENESIS_HEADER
    assert pow_host.pow_digest(header, "x11") == \
        ref_pow_host.pow_digest(header, "x11") == ref_x11.x11_digest(header)
    rows = [bytes(_headers(5, 3)[i]) for i in range(3)]
    assert pow_host.pow_digests(rows, "x11") == [ref_x11.x11_digest(r)
                                                 for r in rows]
    for digest_fn in (pow_host.pow_digest, ref_pow_host.pow_digest):
        with pytest.raises(ValueError, match="not certified canonical"):
            digest_fn(header, "dash")


def test_validation_backend_matches_the_reference_numpy_tier():
    headers = _headers(40, 40)
    d = _ref_digests(headers, port_shavite.active_cnt_variant())
    # every fifth share forged: its target one below its digest
    targets = [_value(x) - (1 if i % 5 == 2 else -7) for i, x in enumerate(d)]
    checks = [validate.ShareCheck(bytes(h), t, "x11")
              for h, t in zip(headers, targets)]
    ref_checks = [ref_validate.ShareCheck(bytes(h), t, "x11")
                  for h, t in zip(headers, targets)]
    want = [i % 5 != 2 for i in range(len(checks))]
    ref = ref_validate.ValidationBackend(min_batch=1, tripwire_rate=0.1,
                                         rolled=True, x11_chain="numpy")
    port = validate.ValidationBackend(device="cpu", min_batch=1,
                                      tripwire_rate=0.1)
    numpy_tier = validate.ValidationBackend(device="cpu", min_batch=1,
                                            tripwire_rate=0.0,
                                            x11_chain="numpy")
    assert asyncio.run(ref.verify_batch(ref_checks)) == want
    assert asyncio.run(port.verify_batch(checks)) == want
    assert asyncio.run(numpy_tier.verify_batch(checks)) == want
    assert port.snapshot()["device_batches"] == 1
    assert port.snapshot()["tripwire_mismatches"] == 0
    # the numpy tier's buffer is the reference's word for word; the plain
    # kernel's has the same failures, count and min, and the failing
    # lanes' top limbs
    ref_buf = ref._device_buffer("x11", ref_checks, 0)
    np_buf = numpy_tier._device_buffer("x11", checks, ref.k)
    assert np_buf.tolist() == ref_buf.tolist()
    k = ref.k
    plain = port._device_buffer("x11", checks, k)
    assert plain[:k].tolist() == ref_buf[:k].tolist()
    assert plain[2 * k:].tolist() == ref_buf[2 * k:].tolist()
    assert plain[k:k + 8].tolist() == [_value(d[i]) >> 224
                                       for i in range(2, 40, 5)]
    with pytest.raises(ValueError, match="x11 validation chain"):
        validate.ValidationBackend(device="cpu", x11_chain="jax")


@pytest.mark.asyncio
async def test_solo_application_mines_x11_shares_on_cpu(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("mining:\n  algorithm: x11\n  backend: torch\n"
                    "  device: cpu\n  batch_size: 32\n  pipeline_depth: 1\n"
                    "work:\n  enabled: true\n  poll_seconds: 0.05\n")
    cfg = load_config(str(path))
    assert cfg.mining.algorithm == "x11"
    assert cfg.validation.x11_chain == "cuda"
    chain = MockChainClient(nbits=0x207FFFFF)   # half of all hashes win
    app = Application(cfg, chain=chain)
    submitted = []
    submit = chain.submit_block

    async def record(header):
        outcome = await submit(header)
        submitted.append((header, outcome))
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
    digests = port_x11.x11_digest_batch(np.stack([
        np.frombuffer(header, np.uint8) for header, _ in submitted]))
    for (header, outcome), digest in zip(submitted, digests):
        # an x11 block candidate: its x11 digest (the port's host chain)
        # meets the target; the mock chain checks blocks by sha256d
        assert _value(digest.tobytes()) <= target
        assert outcome.accepted == (_value(pow_host.sha256d(header)) <= target)
    snap = app.snapshot()["engine"]
    assert snap["algorithm"] == "x11" and snap["shares"]["found"] >= 3
    (backend,) = app.engine.backends.values()
    assert isinstance(backend, search.X11TorchBackend)
